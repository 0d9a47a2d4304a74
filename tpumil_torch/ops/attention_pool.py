"""DSMIL attention pooling of one bag, forward and streaming backward
(counterpart of tpumil/ops/dsmil_pallas.py).

    Q = q(feats)                      N x D  (Linear->ReLU->Linear->Tanh, D=128)
    A = softmax_N(Q q_max^T / sqrt(D))
    B = A^T feats                     C x K  (passing_v=False: V = feats)

Four wrappers of the hand-written Hopper kernels in
``csrc/attention_pool.cu`` and ``csrc/attention_pool_bf16.cu``:

  * ``attention_pool_fwd`` (K1): ``(B [C, K], m [C], s [C], logits [N,
    C])``, the softmax max and denominator and the masked logits kept as
    residuals for the backward;
  * ``attention_pool_fwd_bf16`` (K1-bf16, the forward only): the same
    outputs in f32 from bf16 feats, W0, W2 and q_max (b0, b2 in f32), with
    the softmax weights rounded to bf16 before they pool the bag;
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
``make_trainable_pool`` (f32 only: bf16 has no backward, as in the JAX
package); ``fused_bag_loss`` and ``fused_bag_forward`` are the training loss
and the eval forward of a DSMIL module, the latter with a bf16 feature
stream on request (``feats_dtype``). Those two take any feature width K and
any bag view: the kernels read rows as 16-byte vectors, so a K that is not a
multiple of 4 (f32) or 8 (bf16) (166 for musk, 230 for elephant, fox and
tiger) or a view that starts off a 16-byte boundary is zero-padded first
(:func:`_aligned`).
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
BF16_TILE = 64  # rows per tile of K1-bf16's card kernel


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


def bf16_partition(n_valid: int, sms: int) -> int:
    """K1-bf16's rows per CTA on a card of ``sms`` SMs: the least multiple
    of ``BF16_TILE`` whose ranges ``[g rpc, (g + 1) rpc)`` cover ``[0,
    n_valid)`` in at most ``sms`` pieces (one persistent CTA per SM)."""
    tiles = -(-int(n_valid) // BF16_TILE)
    return -(-tiles // int(sms)) * BF16_TILE


def bf16_segment_rows(device: torch.device, n_valid: int) -> int:
    """The rows per CTA that K1-bf16 takes on ``device``'s card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bf16_partition(n_valid, sms)


def _segments(n: int, n_valid: int, segment_rows: Optional[int]):
    """Row ranges ``[g sr, (g + 1) sr)`` over the valid rows, the last one
    running on to N (its rows >= n_valid weigh 0); one range of every row
    when ``segment_rows`` is None."""
    sr = n if segment_rows is None else int(segment_rows)
    return [(r0, r0 + sr if r0 + sr < n_valid else n)
            for r0 in range(0, n_valid, sr)]


def _online_pool(logits, f, tile_n: int, rounded):
    """One segment's online softmax, ``tile_n`` rows at a time: (acc [C, K],
    m [C], s [C]) as the TPU kernel's grid carries them."""
    c, k = logits.shape[1], f.shape[1]
    m = torch.full((c,), NEG_INF, device=f.device)
    s = torch.zeros((c,), device=f.device)
    acc = torch.zeros((c, k), device=f.device)
    for r0 in range(0, f.shape[0], tile_n):
        a = logits[r0:r0 + tile_n]
        m_new = torch.maximum(m, a.amax(dim=0))
        corr = torch.exp(m - m_new)
        p = torch.exp(a - m_new)
        m = m_new
        s = s * corr + p.sum(dim=0)
        acc = acc * corr[:, None] + rounded(p).T @ f[r0:r0 + tile_n]
    return acc, m, s


def attention_pool_bf16_plain(feats, w0, b0, w2, b2, q_max, n_valid: int,
                              nonlinear: bool = True, tile_n: int = 1024,
                              segment_rows: Optional[int] = None):
    """K1-bf16's plain version: ``(B [C, K], m [C], s [C], logits [N, C])``
    in f32. feats, W0, W2 and q_max are rounded to bf16; h, q and the logits
    stay f32 (a product of an f32 and a bf16 operand runs in f32, as in the
    JAX package on the CPU). The softmax weights ``p = exp(l - m)`` are
    rounded to bf16 before they pool f, and ``s`` sums the unrounded ``p``.
    ``tile_n`` rows at a time, ``m`` is the running max after each tile and
    the accumulators are rescaled by ``exp(m_old - m_new)``, as the TPU
    kernel's online softmax does. The rows run in segments of
    ``segment_rows`` (None: one segment), each with its own online softmax
    from its first row, merged as ``m = max m_g``, ``s = sum s_g
    exp(m_g - m)``, ``B = sum acc_g exp(m_g - m) / s``. The defaults are
    the TPU kernel's rounding points (the CPU wrapper's); ``tile_n=
    BF16_TILE, segment_rows=bf16_segment_rows(...)`` the card kernel's."""
    def rounded(t):
        return t.to(torch.bfloat16).float()

    f = rounded(feats)
    _, _, _, logits, _ = _recompute(
        f, rounded(w0), b0.float(), None if w2 is None else rounded(w2),
        None if b2 is None else b2.float(), rounded(q_max), n_valid, nonlinear)
    parts = [_online_pool(logits[r0:r1], f[r0:r1], tile_n, rounded)
             for r0, r1 in _segments(f.shape[0], n_valid, segment_rows)]
    accs, ms, ss = (torch.stack(t) for t in zip(*parts))
    m = ms.amax(dim=0)
    w = torch.exp(ms - m)
    s = (ss * w).sum(dim=0)
    return ((accs * w[:, :, None]).sum(dim=0) / s.clamp_min(1e-30)[:, None],
            m, s, logits)


def _row_max(logits, n_valid, tile_n, segment_rows):
    """The running max [N, C] against which each row's weight is rounded."""
    out = torch.empty_like(logits)
    for r0, r1 in _segments(logits.shape[0], n_valid, segment_rows):
        m = torch.full((logits.shape[1],), NEG_INF, device=logits.device)
        for t0 in range(r0, r1, tile_n):
            m = torch.maximum(m, logits[t0:min(t0 + tile_n, r1)].amax(dim=0))
            out[t0:min(t0 + tile_n, r1)] = m
    return out


def bf16_rounding_slack(feats, logits, other_logits, m, s, n_valid: int,
                        tile_n: int = 1024,
                        segment_rows: Optional[int] = None) -> torch.Tensor:
    """How far two computations of K1-bf16's B [C, K] may lie apart through
    the bf16 rounding of the softmax weights alone, per class [C]: a weight
    ``p = exp(l - m_run)``, rounded against the running max of its tile
    (the rounding points ``tile_n`` and ``segment_rows`` of
    ``attention_pool_bf16_plain``), whose value lies within ``p (|l - l'| +
    |m_run - m_run'|)`` (plus a few f32 ulps of exp) of a bf16 rounding
    midpoint may round to the other neighbour in the other computation,
    which moves B[c] by one bf16 spacing of p, times ``exp(m_run - m)`` and
    the row's largest |f|, over s. ``logits`` and ``other_logits`` are the
    two computations' logits [N, C]; rows ``>= n_valid`` are padding."""
    lg = logits.float()
    other = other_logits.float()
    mr = _row_max(lg, n_valid, tile_n, segment_rows)[:n_valid]
    drift = (_row_max(other, n_valid, tile_n, segment_rows)[:n_valid]
             - mr).abs()
    lg, other = lg[:n_valid], other[:n_valid]
    p = torch.exp(lg - mr)
    lower = (p.view(torch.int32) & -65536).view(torch.float32)  # truncated
    spacing = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8)
    near = (p - (lower + spacing / 2)).abs() <= p * (
        (other - lg).abs() + drift + 1e-6)
    fmax = feats[:n_valid].float().abs().amax(dim=1, keepdim=True)
    return (near * spacing * torch.exp(mr - m) * fmax).sum(dim=0) / s


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

def _check(feats, n_valid, nonlinear, w0, b0, w2, b2, q_max, *stats,
           stream: torch.dtype = torch.float32) -> None:
    """Shapes, dtype, device and layout of K1's, K1-bf16's and K3's inputs,
    checked before any pointer reaches a kernel. ``stream`` is the dtype of
    feats, W0, W2 and q_max (float32, or bfloat16 for K1-bf16); the biases
    and ``stats``, (m, s, dB, s_red) for K3, are float32."""
    if feats.dim() != 2 or q_max.dim() != 2:
        raise ValueError(f"feats must be [N, K] and q_max [C, D], got "
                         f"{tuple(feats.shape)} and {tuple(q_max.shape)}")
    n, k = feats.shape
    c, d = q_max.shape[0], ATTN_DIM
    f32 = torch.float32
    want = [(feats, (n, k), stream), (w0, (d, k), stream), (b0, (d,), f32),
            (q_max, (c, d), stream)]
    if nonlinear:
        if w2 is None or b2 is None:
            raise ValueError("the nonlinear q needs w2 and b2")
        want += [(w2, (d, d), stream), (b2, (d,), f32)]
    want += [(t, shape, f32)
             for t, shape in zip(stats, [(c,), (c,), (c, k), (c,)])]
    # feats, W0, (K3) dB and (K1-bf16's TMA loads) W2 are copied to shared
    # memory as 16-byte vectors
    tma = [w2] if stream == torch.bfloat16 and nonlinear else []
    _validate(feats, n_valid, c, want, [feats, w0] + list(stats[2:3]) + tma)


def _check_bwd1(feats, logits, m, s, db, n_valid) -> None:
    """K2's inputs, as ``_check``."""
    if feats.dim() != 2 or logits.dim() != 2:
        raise ValueError(f"feats must be [N, K] and logits [N, C], got "
                         f"{tuple(feats.shape)} and {tuple(logits.shape)}")
    n, k = feats.shape
    c = logits.shape[1]
    want = [(t, shape, torch.float32) for t, shape in
            [(feats, (n, k)), (logits, (n, c)), (m, (c,)), (s, (c,)),
             (db, (c, k))]]
    # feats and dB are read as 16-byte vectors
    _validate(feats, n_valid, c, want, [feats, db])


def _validate(feats, n_valid, c, want, vectors) -> None:
    n, k = feats.shape
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{c} classes; the kernels take 1..{MAX_CLASSES}")
    if not 1 <= int(n_valid) <= n:
        raise ValueError(f"n_valid={n_valid} outside 1..{n}")
    for t, shape, dtype in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"expected a {dtype} tensor of shape {shape}, "
                             f"got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"tensors on {t.device} and {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"expected a contiguous tensor, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    if feats.device.type == "cuda":
        per = 16 // feats.element_size()
        if k % per != 0:
            raise ValueError(f"K={k}: the kernels read rows as 16-byte "
                             f"vectors and need K % {per} == 0 for "
                             f"{feats.dtype}")
        if any(t.data_ptr() % 16 for t in vectors):
            raise ValueError("feats, w0, dB and (bf16) w2 must start on a "
                             "16-byte boundary")
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


def _launch_fwd(entry: str, feats, w0, b0, w2, b2, q_max, n_valid: int,
                nonlinear: bool, *extra: int):
    """Launch K1 (``entry`` = ``tpumil_attention_pool_fwd``) or K1-bf16
    (``..._bf16``, whose ``extra`` is its rows per CTA): the two take the
    same arguments and give the same f32 outputs."""
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    n, k = feats.shape
    c = q_max.shape[0]
    with torch.cuda.device(feats.device):
        scratch = _scratch(getattr(lib, entry + "_scratch")(
            int(nonlinear), n, int(n_valid), k, c, *extra), 1, feats, c)
        out = torch.empty((c, k), device=feats.device)
        m = torch.empty((c,), device=feats.device)
        s = torch.empty((c,), device=feats.device)
        logits = torch.empty((n, c), device=feats.device)
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = getattr(lib, entry)(
            *_launch_args(feats, w0, b0, w2, b2, q_max), n, int(n_valid), k,
            c, int(nonlinear), *extra, scratch.data_ptr(), out.data_ptr(),
            m.data_ptr(), s.data_ptr(), logits.data_ptr(), stream)
    _raise_on(err, entry[len("tpumil_"):])
    return out, m, s, logits


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
    out = _launch_fwd("tpumil_attention_pool_fwd", feats, w0, b0, w2, b2,
                      q_max, n_valid, nonlinear)
    attention_pool_fwd.launches += 1
    return out


def attention_pool_fwd_bf16(feats, w0, b0, w2, b2, q_max, n_valid: int,
                            nonlinear: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """K1-bf16: K1's outputs, in f32, from bf16 ``feats``, ``w0``, ``w2``
    and ``q_max`` and f32 ``b0``, ``b2``. On the CPU it rounds the softmax
    weights per tile of 1024 rows against the running max, as the TPU
    kernel's grid does (dsmil_pallas.fused_bag_forward's tile_n); on the
    card per 64-row tile against the running max of each CTA's range of
    ``bf16_segment_rows`` rows, the ranges merged in a fixed order (see
    ``attention_pool_bf16_plain``)."""
    _check(feats, n_valid, nonlinear, w0, b0, w2, b2, q_max,
           stream=torch.bfloat16)
    if feats.device.type == "cpu":
        return attention_pool_bf16_plain(feats, w0, b0, w2, b2, q_max,
                                         n_valid, nonlinear)
    out = _launch_fwd("tpumil_attention_pool_fwd_bf16", feats, w0, b0, w2,
                      b2, q_max, n_valid, nonlinear,
                      bf16_segment_rows(feats.device, n_valid))
    attention_pool_fwd_bf16.launches += 1
    return out


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
attention_pool_fwd_bf16.launches = 0
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


def _instance_stream(model, feats, n_valid):
    """(instance logits [N, C], row mask or None, q_max [C, D])."""
    c_logits = model.instance_logits(feats)
    mask = None
    if n_valid < feats.shape[0]:
        mask = torch.arange(feats.shape[0], device=feats.device) < n_valid
    crit = masked_argmax(c_logits, mask, dim=0)
    return c_logits, mask, model.queries(feats[crit])


def _aligned(feats, w0, dtype: torch.dtype = torch.float32):
    """``(feats, W0)`` in ``dtype`` as the kernels read them: when K is not a
    multiple of a 16-byte row's elements (4 in f32, 8 in bf16), feats starts
    off a 16-byte boundary or the dtype differs, copies into a fresh
    (aligned) tensor, cast in the same copy, with K zero-padded to that
    multiple where it is not one; else the inputs themselves. Exact: the
    zero columns add nothing to z1 = f W0^T, and the callers cut B's extra
    columns off before the bag head."""
    k = feats.shape[1]
    per = 16 // torch.empty((), dtype=dtype).element_size()
    kp = -(-k // per) * per
    if kp == k:
        if feats.data_ptr() % 16 == 0 and feats.dtype == dtype:
            return feats, w0.to(dtype)
        return feats.to(dtype, memory_format=torch.contiguous_format,
                        copy=True), w0.to(dtype)
    padded = feats.new_empty((feats.shape[0], kp), dtype=dtype)
    padded[:, :k] = feats
    padded[:, k:] = 0
    return padded, torch.nn.functional.pad(w0, (0, kp - k)).to(dtype)


def fused_bag_loss(model, feats: torch.Tensor, label: torch.Tensor,
                   pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dual-stream DSMIL loss of one unpadded bag with the attention
    pooling through ``TrainablePool`` (the ONE definition, as
    make_fused_bag_loss is). q_max = q(feats[crit]) stays outside the
    Function, in plain autograd. Needs the nonlinear q and
    passing_v=False. A bf16 bag (a bf16 store's) is taken in f32."""
    if not model.cfg.nonlinear or model.cfg.passing_v:
        raise ValueError("fused_bag_loss needs nonlinear q and passing_v=False")
    from tpumil_torch.utils.device import disable_tf32

    disable_tf32()
    n_valid = feats.shape[0]
    feats = feats.float()  # a bf16 store's bag: f32 from here on
    c_logits, mask, q_max = _instance_stream(model, feats, n_valid)
    w0, b0, w2, b2 = _q_weights(model)
    f, w0 = _aligned(feats, w0)
    bemb = TrainablePool.apply(f, w0, b0, w2, b2, q_max, n_valid, True)
    bemb = bemb[:, :feats.shape[1]]
    return dual_stream_loss(model.bag_head(bemb),
                            masked_max(c_logits, mask, dim=0), label,
                            pos_weight)


def fused_bag_forward(model, feats: torch.Tensor,
                      n_valid: Optional[int] = None, *,
                      feats_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bag_logits [C], max_instance_logits [C])`` of one bag through K1,
    or through K1-bf16 with ``feats_dtype=torch.bfloat16``: then only the
    pool's inputs (feats, W0, W2, q_max) are cast to bf16, and the instance
    stream, the critical instances, q_max = q(feats[crit]) and the bag head
    stay f32 on the given feats, as in the JAX package; bf16 feats (a bf16
    store's bag) are taken in f32 there. Refuses a passing_v
    model: the kernel pools raw feats as the value stream, and ignoring a
    v-projection would return wrong logits."""
    if model.cfg.passing_v:
        raise ValueError("fused_bag_forward requires passing_v=False "
                         "(the model has a 'v' projection)")
    if feats_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {feats_dtype}")
    from tpumil_torch.utils.device import disable_tf32

    disable_tf32()
    n_valid = feats.shape[0] if n_valid is None else int(n_valid)
    pool = (attention_pool_fwd if feats_dtype == torch.float32
            else attention_pool_fwd_bf16)
    with torch.no_grad():
        f32 = feats.float()  # a bf16 store's bag: one f32 copy
        c_logits, mask, q_max = _instance_stream(model, f32, n_valid)
        w0, b0, w2, b2 = _q_weights(model)
        f, w0 = _aligned(f32 if feats_dtype == torch.float32 else feats,
                         w0.detach(), feats_dtype)
        bemb = pool(f, w0, b0.detach(),
                    None if w2 is None else w2.detach().to(feats_dtype),
                    None if b2 is None else b2.detach(),
                    q_max.to(feats_dtype), n_valid, model.cfg.nonlinear)[0]
        bemb = bemb[:, :feats.shape[1]]
        return model.bag_head(bemb), masked_max(c_logits, mask, dim=0)
