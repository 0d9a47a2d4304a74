"""DSMIL attention pooling of one bag, forward and streaming backward
(counterpart of tpumil/ops/dsmil_pallas.py).

    Q = q(feats)                      N x D  (Linear->ReLU->Linear->Tanh, D=128)
    A = softmax_N(Q q_max^T / sqrt(D))
    B = A^T feats                     C x K  (passing_v=False: V = feats)

Three wrappers of the hand-written Hopper kernels in
``csrc/attention_pool.cu``:

  * ``attention_pool_fwd`` (K1): ``(B [C, K], m [C], s [C], logits [N,
    C])``, the softmax max and denominator and the masked logits kept as
    residuals for the backward;
  * ``attention_pool_bwd1`` (K2): ``s_red[c] = sum_n A[n,c] (f_n . dB_c)``
    from K1's logits, one read of the bag;
  * ``attention_pool_bwd2`` (K3): ``(dF, dW0, db0, dW2, db2, dq_max)``,
    recomputing every activation tile by tile from (m, s); dF only when
    asked for (``need_df``), else ``None``.

Rows ``>= n_valid`` are padding: they get exactly zero attention and zero
``dF``. Bags in this package are unpadded (``n_valid = N``); the argument
lets the JAX package's padded inputs compare directly.

Each wrapper runs its plain PyTorch version (``*_plain``, the unfused eager
math) on a CPU tensor, and on a CUDA tensor launches its kernel or raises.
``TrainablePool`` is the ``torch.autograd.Function`` of
``make_trainable_pool``; ``fused_bag_loss`` and ``fused_bag_forward`` are the
training loss and the eval forward of a DSMIL module through it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpumil_torch.ops.losses import dual_stream_loss
from tpumil_torch.ops.masked import NEG_INF, masked_argmax, masked_max

ATTN_DIM = 128
SCALE = 1.0 / math.sqrt(ATTN_DIM)
MAX_CLASSES = 8  # the kernels' compile-time bound (CMAX)


# -- plain PyTorch versions --------------------------------------------------

def _valid_rows(feats, n_valid):
    """Row mask [N, 1]: rows ``>= n_valid`` are padding."""
    return (torch.arange(feats.shape[0], device=feats.device)
            < n_valid)[:, None]


def _recompute(feats, w0, b0, w2, b2, q_max, n_valid, nonlinear):
    """(z1, h, q, masked logits [N, C], row mask [N, 1])."""
    z1 = feats @ w0.T + b0
    if nonlinear:
        h = torch.relu(z1)
        q = torch.tanh(h @ w2.T + b2)
    else:
        h = q = z1
    valid = _valid_rows(feats, n_valid)
    logits = torch.where(valid, (q @ q_max.T) * SCALE,
                         torch.full((), NEG_INF, device=feats.device))
    return z1, h, q, logits, valid


def _attention(logits, valid, m, s):
    return torch.where(valid, torch.exp(logits - m) / s.clamp_min(1e-30), 0.0)


def attention_pool_plain(feats, w0, b0, w2, b2, q_max, n_valid: int,
                         nonlinear: bool = True):
    """K1's plain version: ``(B [C, K], m [C], s [C], logits [N, C])``, the
    logits of rows ``>= n_valid`` at ``NEG_INF``."""
    _, _, _, logits, valid = _recompute(feats, w0, b0, w2, b2, q_max, n_valid,
                                        nonlinear)
    m = logits.amax(dim=0)
    s = torch.where(valid, torch.exp(logits - m), 0.0).sum(dim=0)
    a = _attention(logits, valid, m, s)
    return a.T @ feats, m, s, logits


def attention_pool_bwd1_plain(feats, logits, m, s, db, n_valid: int):
    """K2's plain version: ``s_red [C]`` from K1's logits."""
    a = _attention(logits, _valid_rows(feats, n_valid), m, s)
    return (a * (feats @ db.T)).sum(dim=0)


def attention_pool_bwd2_plain(feats, w0, b0, w2, b2, q_max, m, s, db, s_red,
                              n_valid: int, nonlinear: bool = True,
                              need_df: bool = True):
    """K3's plain version: ``(dF, dW0, db0, dW2, db2, dq_max)``; the
    closed-form gradients of ``sum(B * dB)``. dW2 and db2 are zeros for the
    linear q; dF is ``None`` unless ``need_df``."""
    z1, h, q, logits, valid = _recompute(feats, w0, b0, w2, b2, q_max,
                                         n_valid, nonlinear)
    a = _attention(logits, valid, m, s)
    dl = a * (feats @ db.T - s_red)
    dq = (dl @ q_max) * SCALE
    dqm = (dl.T @ q) * SCALE
    if nonlinear:
        dz2 = dq * (1.0 - q * q)
        dw2, db2 = dz2.T @ h, dz2.sum(dim=0)
        dz1 = (dz2 @ w2) * (z1 > 0)
    else:
        dw2 = torch.zeros((ATTN_DIM, ATTN_DIM), device=feats.device)
        db2 = torch.zeros((ATTN_DIM,), device=feats.device)
        dz1 = dq
    df = a @ db + dz1 @ w0 if need_df else None
    return df, dz1.T @ feats, dz1.sum(dim=0), dw2, db2, dqm


# -- kernel wrappers -----------------------------------------------------------

def _check(feats, n_valid, nonlinear, w0, b0, w2, b2, q_max, *stats) -> None:
    """Shapes, dtype, device and layout of K1's and K3's inputs, checked
    before any pointer reaches a kernel. ``stats`` is (m, s, dB, s_red)
    for K3."""
    if feats.dim() != 2 or q_max.dim() != 2:
        raise ValueError(f"feats must be [N, K] and q_max [C, D], got "
                         f"{tuple(feats.shape)} and {tuple(q_max.shape)}")
    n, k = feats.shape
    c, d = q_max.shape[0], ATTN_DIM
    want = [(feats, (n, k)), (w0, (d, k)), (b0, (d,)), (q_max, (c, d))]
    if nonlinear:
        if w2 is None or b2 is None:
            raise ValueError("the nonlinear q needs w2 and b2")
        want += [(w2, (d, d)), (b2, (d,))]
    want += list(zip(stats, [(c,), (c,), (c, k), (c,)]))
    # feats, W0 and (K3) dB are copied to shared memory as 16-byte vectors
    _validate(feats, n_valid, c, want, [feats, w0] + list(stats[2:3]))


def _check_bwd1(feats, logits, m, s, db, n_valid) -> None:
    """K2's inputs, as ``_check``."""
    if feats.dim() != 2 or logits.dim() != 2:
        raise ValueError(f"feats must be [N, K] and logits [N, C], got "
                         f"{tuple(feats.shape)} and {tuple(logits.shape)}")
    n, k = feats.shape
    c = logits.shape[1]
    want = [(feats, (n, k)), (logits, (n, c)), (m, (c,)), (s, (c,)),
            (db, (c, k))]
    # feats and dB are read as 16-byte vectors
    _validate(feats, n_valid, c, want, [feats, db])


def _validate(feats, n_valid, c, want, vectors) -> None:
    n, k = feats.shape
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{c} classes; the kernels take 1..{MAX_CLASSES}")
    if not 1 <= int(n_valid) <= n:
        raise ValueError(f"n_valid={n_valid} outside 1..{n}")
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32 tensors, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"tensors on {t.device} and {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"expected a contiguous tensor, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    if feats.device.type == "cuda":
        if k % 4 != 0:
            raise ValueError(f"K={k}: the kernels read rows as 16-byte "
                             "vectors and need K % 4 == 0")
        if any(t.data_ptr() % 16 for t in vectors):
            raise ValueError("feats, w0 and dB must start on a 16-byte "
                             "boundary")
    elif feats.device.type != "cpu":
        raise ValueError(f"unsupported device {feats.device}")


def _launch_args(feats, w0, b0, w2, b2, q_max):
    return [feats.data_ptr(), w0.data_ptr(), b0.data_ptr(),
            None if w2 is None else w2.data_ptr(),
            None if b2 is None else b2.data_ptr(), q_max.data_ptr()]


def _scratch(floats: int, which: int, feats, c) -> torch.Tensor:
    """Kernel ``which``'s scratch of ``floats`` floats, as its plan
    returned it (``-(CUDA error)`` when it has no launch configuration)."""
    if floats <= 0:
        n, k = feats.shape
        raise RuntimeError(f"attention_pool kernel {which}: no launch "
                           f"configuration (CUDA error {-floats}) for N={n}, "
                           f"K={k}, C={c}")
    return torch.empty((floats,), device=feats.device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def attention_pool_fwd(feats, w0, b0, w2, b2, q_max, n_valid: int,
                       nonlinear: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """K1: ``(B [C, K], m [C], s [C], logits [N, C])`` of one bag, the
    logits of rows ``>= n_valid`` at ``NEG_INF``. ``w2``/``b2`` are ignored
    (may be None) for the linear q."""
    _check(feats, n_valid, nonlinear, w0, b0, w2, b2, q_max)
    if feats.device.type == "cpu":
        return attention_pool_plain(feats, w0, b0, w2, b2, q_max, n_valid,
                                    nonlinear)
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    n, k = feats.shape
    c = q_max.shape[0]
    with torch.cuda.device(feats.device):
        scratch = _scratch(lib.tpumil_attention_pool_fwd_scratch(
            int(nonlinear), n, int(n_valid), k, c), 1, feats, c)
        out = torch.empty((c, k), device=feats.device)
        m = torch.empty((c,), device=feats.device)
        s = torch.empty((c,), device=feats.device)
        logits = torch.empty((n, c), device=feats.device)
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.tpumil_attention_pool_fwd(
            *_launch_args(feats, w0, b0, w2, b2, q_max), n, int(n_valid), k,
            c, int(nonlinear), scratch.data_ptr(), out.data_ptr(),
            m.data_ptr(), s.data_ptr(), logits.data_ptr(), stream)
    _raise_on(err, "attention_pool_fwd")
    attention_pool_fwd.launches += 1
    return out, m, s, logits


def attention_pool_bwd1(feats, logits, m, s, db, n_valid: int
                        ) -> torch.Tensor:
    """K2: ``s_red [C]`` from K1's ``logits`` and (m, s)."""
    _check_bwd1(feats, logits, m, s, db, n_valid)
    if feats.device.type == "cpu":
        return attention_pool_bwd1_plain(feats, logits, m, s, db, n_valid)
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    n, k = feats.shape
    c = logits.shape[1]
    with torch.cuda.device(feats.device):
        scratch = _scratch(lib.tpumil_attention_pool_bwd1_scratch(
            n, int(n_valid), k, c), 2, feats, c)
        s_red = torch.empty((c,), device=feats.device)
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.tpumil_attention_pool_bwd1(
            feats.data_ptr(), logits.data_ptr(), m.data_ptr(), s.data_ptr(),
            db.data_ptr(), n, int(n_valid), k, c, scratch.data_ptr(),
            s_red.data_ptr(), stream)
    _raise_on(err, "attention_pool_bwd1")
    attention_pool_bwd1.launches += 1
    return s_red


def attention_pool_bwd2(feats, w0, b0, w2, b2, q_max, m, s, db, s_red,
                        n_valid: int, nonlinear: bool = True,
                        need_df: bool = True):
    """K3: ``(dF [N, K], dW0 [D, K], db0 [D], dW2 [D, D], db2 [D],
    dq_max [C, D])``. dF is computed only when ``need_df`` (else ``None``):
    bag features are constants in training, and dF [N, K] would be the
    largest buffer of the step."""
    _check(feats, n_valid, nonlinear, w0, b0, w2, b2, q_max, m, s, db,
           s_red)
    if feats.device.type == "cpu":
        return attention_pool_bwd2_plain(feats, w0, b0, w2, b2, q_max, m, s,
                                         db, s_red, n_valid, nonlinear,
                                         need_df)
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    n, k = feats.shape
    c = q_max.shape[0]
    d = ATTN_DIM
    with torch.cuda.device(feats.device):
        scratch = _scratch(lib.tpumil_attention_pool_bwd2_scratch(
            int(nonlinear), n, int(n_valid), k, c, int(need_df)), 3, feats, c)
        size = int(lib.tpumil_attention_pool_bwd2_size(k, c))
        grads = torch.empty((size,), device=feats.device)
        df = torch.empty((n, k), device=feats.device) if need_df else None
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.tpumil_attention_pool_bwd2(
            *_launch_args(feats, w0, b0, w2, b2, q_max), m.data_ptr(),
            s.data_ptr(), db.data_ptr(), s_red.data_ptr(), n, int(n_valid),
            k, c, int(nonlinear), int(need_df), scratch.data_ptr(),
            None if df is None else df.data_ptr(), grads.data_ptr(), stream)
    _raise_on(err, "attention_pool_bwd2")
    attention_pool_bwd2.launches += 1
    dw0, db0, dw2, db2, dqm = torch.split(grads, [d * k, d, d * d, d, c * d])
    return (df, dw0.view(d, k), db0, dw2.view(d, d), db2, dqm.view(c, d))


# kernel launches since the last reset (plain ints: chip_smoke.py and the
# tests zero them and read them to show a path went through the kernels)
attention_pool_fwd.launches = 0
attention_pool_bwd1.launches = 0
attention_pool_bwd2.launches = 0


class TrainablePool(torch.autograd.Function):
    """``B = pool(feats, w0, b0, w2, b2, q_max)`` with the streaming
    backward (K2 then K3) in place of autograd through Q and A: the saved
    residuals are the inputs, the softmax stats (m, s) and the logits [N, C]
    (K2 reads them), and no [N, D] activation is kept. K3 computes dF [N, K]
    only when feats need a gradient (``ctx.needs_input_grad[0]``);
    otherwise their gradient is ``None``. For the linear q pass
    ``w2 = b2 = None``."""

    @staticmethod
    def forward(ctx, feats, w0, b0, w2, b2, q_max, n_valid: int,
                nonlinear: bool):
        out, m, s, logits = attention_pool_fwd(feats, w0, b0, w2, b2, q_max,
                                               n_valid, nonlinear)
        ctx.save_for_backward(feats, w0, b0, w2, b2, q_max, m, s, logits)
        ctx.n_valid, ctx.nonlinear = int(n_valid), bool(nonlinear)
        return out

    @staticmethod
    def backward(ctx, db):
        feats, w0, b0, w2, b2, q_max, m, s, logits = ctx.saved_tensors
        db = db.contiguous()
        s_red = attention_pool_bwd1(feats, logits, m, s, db, ctx.n_valid)
        df, dw0, db0, dw2, db2, dqm = attention_pool_bwd2(
            feats, w0, b0, w2, b2, q_max, m, s, db, s_red, ctx.n_valid,
            ctx.nonlinear, ctx.needs_input_grad[0])
        if not ctx.nonlinear:
            dw2 = db2 = None
        return df, dw0, db0, dw2, db2, dqm, None, None


def _q_weights(model):
    q = model.b_classifier.q
    if model.cfg.nonlinear:
        return q[0].weight, q[0].bias, q[2].weight, q[2].bias
    return q.weight, q.bias, None, None


def _bag_logits(model, bemb):
    fcc = model.b_classifier.fcc
    return torch.einsum("ck,dck->d", bemb, fcc.weight) + fcc.bias


def _instance_stream(model, feats, n_valid):
    """(instance logits [N, C], row mask or None, q_max [C, D])."""
    c_logits = model.i_classifier.fc(feats)
    mask = None
    if n_valid < feats.shape[0]:
        mask = torch.arange(feats.shape[0], device=feats.device) < n_valid
    crit = masked_argmax(c_logits, mask, dim=0)
    return c_logits, mask, model.b_classifier.q(feats[crit])


def fused_bag_loss(model, feats: torch.Tensor, label: torch.Tensor,
                   pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dual-stream DSMIL loss of one unpadded bag with the attention
    pooling through ``TrainablePool`` (the ONE definition, as
    make_fused_bag_loss is). q_max = q(feats[crit]) stays outside the
    Function, in plain autograd. Needs the nonlinear q and
    passing_v=False."""
    if not model.cfg.nonlinear or model.cfg.passing_v:
        raise ValueError("fused_bag_loss needs nonlinear q and passing_v=False")
    from tpumil_torch.utils.device import disable_tf32

    disable_tf32()
    n_valid = feats.shape[0]
    c_logits, mask, q_max = _instance_stream(model, feats, n_valid)
    w0, b0, w2, b2 = _q_weights(model)
    bemb = TrainablePool.apply(feats, w0, b0, w2, b2, q_max, n_valid, True)
    return dual_stream_loss(_bag_logits(model, bemb),
                            masked_max(c_logits, mask, dim=0), label,
                            pos_weight)


def fused_bag_forward(model, feats: torch.Tensor,
                      n_valid: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bag_logits [C], max_instance_logits [C])`` of one bag through K1.
    Refuses a passing_v model: the kernel pools raw feats as the value
    stream, and ignoring a v-projection would return wrong logits."""
    if model.cfg.passing_v:
        raise ValueError("fused_bag_forward requires passing_v=False "
                         "(the model has a 'v' projection)")
    from tpumil_torch.utils.device import disable_tf32

    disable_tf32()
    n_valid = feats.shape[0] if n_valid is None else int(n_valid)
    with torch.no_grad():
        c_logits, mask, q_max = _instance_stream(model, feats, n_valid)
        w0, b0, w2, b2 = _q_weights(model)
        bemb = attention_pool_fwd(feats, w0.detach(), b0.detach(),
                                  None if w2 is None else w2.detach(),
                                  None if b2 is None else b2.detach(),
                                  q_max, n_valid, model.cfg.nonlinear)[0]
        return _bag_logits(model, bemb), masked_max(c_logits, mask, dim=0)
