"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card of capability (9, 0). Every test skips without one.

This file imports neither jax nor tpumil, so it also runs on a machine
without JAX; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpumil_torch.ops.instance_norm import (fused_instance_norm,
                                            instance_norm_plain,
                                            plan_instance_norm)

# f32: the same statistics summed in another order; bf16: outputs rounded to
# bf16 may differ by one bf16 step (2^-7 relative)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}


@pytest.fixture
def card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs a CUDA card of capability (9, 0)")
    return torch.device("cuda")


def _check(x, relu, tol):
    before = fused_instance_norm.launches
    got = fused_instance_norm(x, relu)
    torch.cuda.synchronize()
    assert fused_instance_norm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    want = instance_norm_plain(x, relu)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 28, 28, 64), (4, 14, 14, 256),
                                   (2, 7, 7, 512), (3, 5, 2, 96),
                                   (2, 3, 3, 3), (1, 1, 1, 8)])
def test_instance_norm_kernel_matches_plain(card, dtype, shape):
    """Vector loads (C a multiple of 16 bytes) and the scalar path (C=3),
    planes from 1 to 784 rows."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1)
                         .astype(np.float32)).to(card, dtype)
    for relu in (False, True):
        _check(x, relu, TOL[dtype])


@pytest.mark.cuda
def test_instance_norm_kernel_misaligned_and_constant(card):
    """A contiguous tensor whose data is not 16-byte aligned takes the
    scalar path; an exactly constant plane gives exact zeros."""
    n, h, w, c = 2, 6, 6, 64
    base = torch.randn(n * h * w * c + 1, device=card)
    x = base[1:].view(n, h, w, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check(x, True, TOL[torch.float32])
    const = torch.full((2, 8, 8, 64), 3.7, device=card)
    out = fused_instance_norm(const)
    assert torch.equal(out, torch.zeros_like(out))


# every route and cluster size of either dtype (plan_instance_norm; f32 /
# bf16 cluster in the comments, 0 = two reads): the ResNet18 sites, the
# stem planes, C = 64 with an odd H*W, C not a multiple of the 16-byte
# vector, several channel blocks
ROUTE_SHAPES = [(2, 112, 112, 64),   # 0 / 8
                (1, 128, 128, 64),   # 0 / 0
                (2, 80, 80, 64),     # 8 / 4
                (2, 50, 50, 128),    # 4 / 4
                (2, 56, 56, 64),     # 4 / 2
                (2, 57, 55, 64),     # 4 / 2, odd H*W
                (4, 28, 28, 128),    # 1 / 1
                (4, 14, 14, 256),    # 1 / 1
                (4, 7, 7, 512),      # 1 / 1
                (2, 30, 30, 130),    # 2 / 2, scalar loads
                (2, 9, 7, 100),      # 1 / 1, scalar in bf16
                (2, 6, 6, 66)]       # 1 / 1, scalar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_instance_norm_routes_match_plain_and_rerun_bitwise(card, dtype,
                                                           shape):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1)
                         .astype(np.float32)).to(card, dtype)
    for relu in (False, True):
        _check(x, relu, TOL[dtype])
    assert torch.equal(fused_instance_norm(x, True),
                       fused_instance_norm(x, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_routes_misaligned_and_constant(card, dtype):
    """A misaligned view over a cluster takes the scalar loads; a constant
    plane gives exact zeros on every route and cluster size."""
    n, h, w, c = 2, 80, 80, 64
    base = torch.randn(n * h * w * c + 1, device=card).to(dtype)
    x = base[1:].view(n, h, w, c)
    assert x.data_ptr() % 16 != 0
    assert plan_instance_norm(x.shape, dtype).cluster >= 4
    _check(x, True, TOL[dtype])
    for shape in ((1, 128, 128, 64), (2, 112, 112, 64), (2, 80, 80, 64),
                  (2, 50, 50, 128), (2, 56, 56, 64), (2, 30, 30, 130),
                  (2, 7, 7, 512)):
        const = torch.full(shape, 3.7, device=card, dtype=dtype)
        out = fused_instance_norm(const, True)
        assert torch.equal(out, torch.zeros_like(out)), shape


@pytest.mark.cuda
def test_instance_norm_kernel_rejects_bad_cuda_input(card):
    with pytest.raises(ValueError, match="dtype"):
        fused_instance_norm(torch.zeros(2, 4, 4, 64, device=card,
                                        dtype=torch.float16))
    x = torch.zeros(2, 64, 4, 4, device=card)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        fused_instance_norm(x.permute(0, 2, 3, 1))


# -- K1-K3: the DSMIL attention pool (csrc/attention_pool.cu) -----------------

from tpumil_torch.ops import attention_pool as ap  # noqa: E402


def _pool_inputs(device, n, n_valid, k, c, nonlinear, seed=0):
    rng = np.random.default_rng(seed)
    d = ap.ATTN_DIM

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    feats = t((n, k), 0.5)
    w = [t((d, k), 0.1), t((d,), 0.1),
         t((d, d), 0.1) if nonlinear else None,
         t((d,), 0.1) if nonlinear else None]
    return feats, w, t((c, d), 0.5), t((c, k), 1.0)


def _close(name, got, want, rtol):
    """|got - want| <= rtol * max|want| + 1e-6: sums over N rows taken in
    another order (per-CTA partials, then a fixed-order merge)."""
    if want is None:
        return
    err = (got - want).abs().max().item()
    bar = rtol * want.abs().max().item() + 1e-6
    assert torch.isfinite(got).all(), name
    assert err <= bar, f"{name}: max abs err {err:.3e} > {bar:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("nonlinear", [True, False])
@pytest.mark.parametrize("n,n_valid,k,c", [(1000, 1000, 512, 2),
                                           (384, 300, 96, 2),
                                           (33, 33, 512, 8),
                                           (1, 1, 64, 1),
                                           (5000, 4097, 128, 3)])
def test_attention_pool_kernels_match_plain(card, nonlinear, n, n_valid, k, c):
    """K1, K2, K3 against their plain versions: ragged last tiles, padded
    rows, one row, up to the 8-class bound. K1's logits too: within 1e-5
    of max|plain| on the valid rows, -1e30 on the padded ones."""
    feats, w, qm, db = _pool_inputs(card, n, n_valid, k, c, nonlinear)
    counts = (ap.attention_pool_fwd.launches, ap.attention_pool_bwd1.launches,
              ap.attention_pool_bwd2.launches)
    out, m, s, logits = ap.attention_pool_fwd(feats, *w, qm, n_valid,
                                              nonlinear)
    torch.cuda.synchronize()
    want_out, want_m, want_s, want_l = ap.attention_pool_plain(
        feats, *w, qm, n_valid, nonlinear)
    _close("B", out, want_out, 1e-4)
    _close("m", m, want_m, 1e-5)
    _close("s", s, want_s, 1e-4)
    _close("logits", logits[:n_valid], want_l[:n_valid], 1e-5)
    assert torch.equal(logits[n_valid:], want_l[n_valid:])
    s_red = ap.attention_pool_bwd1(feats, want_l, want_m, want_s, db, n_valid)
    torch.cuda.synchronize()
    want_red = ap.attention_pool_bwd1_plain(feats, want_l, want_m, want_s, db,
                                            n_valid)
    _close("s_red", s_red, want_red, 1e-4)
    got = ap.attention_pool_bwd2(feats, *w, qm, want_m, want_s, db, want_red,
                                 n_valid, nonlinear)
    torch.cuda.synchronize()
    want = ap.attention_pool_bwd2_plain(feats, *w, qm, want_m, want_s, db,
                                        want_red, n_valid, nonlinear)
    for name, g, x in zip(("dF", "dW0", "db0", "dW2", "db2", "dq_max"),
                          got, want):
        _close(name, g, x, 1e-3)
    assert not got[0][n_valid:].any()
    assert (ap.attention_pool_fwd.launches, ap.attention_pool_bwd1.launches,
            ap.attention_pool_bwd2.launches) == tuple(x + 1 for x in counts)


def _off_kink(device, n, k, c, nonlinear, seed, gap=1e-5):
    """_pool_inputs with n rows whose z1 = f W0^T + b0 (in float64) keeps
    |z1| > gap: at the ReLU's kink the gradient jumps, and two f32
    computations of z1 may take opposite sides of it (of the 8.4M z1 values
    at N = 65529, about one lies within f32 rounding of 0)."""
    feats, w, qm, db = _pool_inputs(device, n + n // 20 + 64, n + n // 20 + 64,
                                    k, c, nonlinear, seed)
    if nonlinear:
        z1 = feats.double() @ w[0].double().T + w[1].double()
        feats = feats[z1.abs().amin(dim=1) > gap]
    return feats[:n].contiguous(), w, qm, db


@pytest.mark.cuda
@pytest.mark.parametrize("nonlinear", [True, False])
def test_attention_pool_fwd_bwd1_f32_bar_at_65529(card, nonlinear):
    """K1 (3xTF32 logits pass, f32 pool pass) and K2 at the training path's
    giant bag on rows off the ReLU's kink: B, m, s and s_red within 1e-5
    of max|plain|, as K3 is held."""
    n = 65529
    feats, w, qm, db = _off_kink(card, n, 512, 2, nonlinear, seed=9)
    assert feats.shape == (n, 512)
    out, m, s, logits = ap.attention_pool_fwd(feats, *w, qm, n, nonlinear)
    want = ap.attention_pool_plain(feats, *w, qm, n, nonlinear)
    for name, g, x in zip(("B", "m", "s", "logits"), (out, m, s, logits),
                          want):
        err = (g - x).abs().max().item()
        assert err <= 1e-5 * x.abs().max().item(), (name, err)
    red = ap.attention_pool_bwd1(feats, want[3], want[1], want[2], db, n)
    want_red = ap.attention_pool_bwd1_plain(feats, want[3], want[1], want[2],
                                            db, n)
    err = (red - want_red).abs().max().item()
    assert err <= 1e-5 * want_red.abs().max().item(), ("s_red", err)


# K3's cases: (N, n_valid, K, C, nonlinear)
BWD2_CASES = [(1000, 1000, 512, 2, True), (1000, 997, 512, 2, False),
              (65529, 65529, 512, 2, True), (5000, 4097, 1024, 3, True),
              (33, 33, 36, 8, True), (1, 1, 64, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_valid,k,c,nonlinear", BWD2_CASES)
def test_attention_pool_bwd2_matches_plain(card, n, n_valid, k, c, nonlinear):
    """K3 (3xTF32 on the tensor cores) against its plain version (cuBLAS
    f32) with dF written and skipped: 1e-3 of max|plain| + 1e-6 everywhere,
    and 1e-5 of max|plain| at N = 65529, which one TF32 pass misses by two
    orders of magnitude (its rows keep z1 off the ReLU's kink). Skipping
    dF leaves every other gradient bitwise equal; a rerun is bitwise
    equal."""
    if n == 65529:
        feats, w, qm, db = _off_kink(card, n, k, c, nonlinear, seed=5)
        assert feats.shape == (n, k)
    else:
        feats, w, qm, db = _pool_inputs(card, n, n_valid, k, c, nonlinear,
                                        seed=5)
    _, m, s, logits = ap.attention_pool_plain(feats, *w, qm, n_valid,
                                              nonlinear)
    red = ap.attention_pool_bwd1_plain(feats, logits, m, s, db, n_valid)
    args = (feats, *w, qm, m, s, db, red, n_valid, nonlinear)
    before = ap.attention_pool_bwd2.launches
    got = ap.attention_pool_bwd2(*args)
    torch.cuda.synchronize()
    want = ap.attention_pool_bwd2_plain(*args)
    names = ("dF", "dW0", "db0", "dW2", "db2", "dq_max")
    for name, g, x in zip(names, got, want):
        if not nonlinear and name in ("dW2", "db2"):
            continue
        _close(name, g, x, 1e-3)
        if n == 65529:
            err = (g - x).abs().max().item()
            assert err <= 1e-5 * x.abs().max().item(), (name, err)
    assert not got[0][n_valid:].any()
    skipped = ap.attention_pool_bwd2(*args, need_df=False)
    assert skipped[0] is None
    for a, b in zip(got[1:], skipped[1:]):
        assert torch.equal(a, b)
    rerun = ap.attention_pool_bwd2(*args)
    for a, b in zip(got, rerun):
        assert torch.equal(a, b)
    assert ap.attention_pool_bwd2.launches == before + 3


@pytest.mark.cuda
def test_trainable_pool_skips_df_for_constant_feats(card):
    """Feats that need no gradient (precomputed bag features): no dF, and
    the parameter gradients are bitwise those of the run that writes dF."""
    feats, w, qm, db = _pool_inputs(card, 3000, 2900, 512, 2, True, seed=6)
    grads = {}
    for need in (True, False):
        leaves = [feats.clone().requires_grad_(need)] + [
            x.clone().requires_grad_(True) for x in [*w, qm]]
        out = ap.TrainablePool.apply(*leaves, 2900, True)
        (out * db).sum().backward()
        grads[need] = [x.grad for x in leaves]
    assert grads[False][0] is None and grads[True][0] is not None
    for a, b in zip(grads[True][1:], grads[False][1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_pool_kernels_are_deterministic(card):
    feats, w, qm, db = _pool_inputs(card, 20000, 19999, 512, 2, True, seed=1)
    runs = []
    for _ in range(2):
        out, m, s, logits = ap.attention_pool_fwd(feats, *w, qm, 19999)
        red = ap.attention_pool_bwd1(feats, logits, m, s, db, 19999)
        runs.append((out, m, s, logits, red) + ap.attention_pool_bwd2(
            feats, *w, qm, m, s, db, red, 19999))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# K1-bf16 against attention_pool_bf16_plain at the kernel's rounding points
# (64-row tiles in each CTA's range of bf16_segment_rows rows). The q-MLP
# splits h and q into bf16 hi + lo (16 bits of each), so the logits, m and s
# carry ~1e-5 relative error: BF16_BAR of their max. A logit that moves may
# flip the bf16 rounding of its weight, which moves B by one bf16 spacing of
# p times |f| / s: B's bar adds ap.bf16_rounding_slack of the two logits.
BF16_BAR = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_valid,k,c,nonlinear",
                         [(1000, 1000, 512, 2, True), (1000, 997, 512, 2, False),
                          (5000, 4097, 128, 3, True), (384, 300, 168, 2, True),
                          (33, 33, 64, 8, True), (1, 1, 64, 1, False),
                          # K = 1024, the multiscale width: 2 tiles per CTA,
                          # the last CTA's range ends in a ragged tile
                          (9000, 8950, 1024, 2, True),
                          # the nonlinear q's resident limit (17 boxes of
                          # 64), C = 3
                          (2000, 1937, 1088, 3, True),
                          # wider than the resident tile: the pool re-reads
                          # the rows from L2
                          (3000, 2900, 2048, 2, True),
                          # the linear q's resident limit (21 boxes), C = 8
                          (4000, 3900, 1344, 8, False),
                          # C = 8 over 3 tiles per CTA, a ragged last tile
                          (20000, 19937, 512, 8, True)])
def test_attention_pool_bf16_kernel_matches_plain(card, n, n_valid, k, c,
                                                  nonlinear):
    """K1-bf16: B, m, s and the valid logits within BF16_BAR of max|plain|
    at the kernel's partition, the padded logits -1e30 exactly, a rerun
    bitwise equal."""
    feats, w, qm, _ = _pool_inputs(card, n, n_valid, k, c, nonlinear)
    bf = torch.bfloat16
    args = [feats.to(bf), w[0].to(bf), w[1],
            None if w[2] is None else w[2].to(bf), w[3], qm.to(bf)]
    before = ap.attention_pool_fwd_bf16.launches
    got = ap.attention_pool_fwd_bf16(*args, n_valid, nonlinear)
    torch.cuda.synchronize()
    assert ap.attention_pool_fwd_bf16.launches == before + 1
    points = dict(tile_n=ap.BF16_TILE,
                  segment_rows=ap.bf16_segment_rows(card, n_valid))
    want = ap.attention_pool_bf16_plain(*args, n_valid, nonlinear, **points)
    slack = ap.bf16_rounding_slack(feats, want[3], got[3], want[1], want[2],
                                   n_valid, **points)
    err = (got[0] - want[0]).abs().amax(dim=1)
    assert (err <= BF16_BAR * want[0].abs().max() + slack + 1e-6).all(), \
        (err, slack)
    for name, g, x in zip(("m", "s"), got[1:3], want[1:3]):
        _close(name, g, x, BF16_BAR)
    _close("logits", got[3][:n_valid], want[3][:n_valid], BF16_BAR)
    assert (got[3][n_valid:] == ap.NEG_INF).all()
    again = ap.attention_pool_fwd_bf16(*args, n_valid, nonlinear)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_pool_bf16_rejects_misaligned_w2(card):
    """K1-bf16 loads W2 by TMA too: a W2 view off a 16-byte boundary is
    refused, not read wrongly."""
    feats, w, qm, _ = _pool_inputs(card, 64, 64, 128, 2, True)
    bf = torch.bfloat16
    base = torch.zeros(128 * 128 + 1, device=card, dtype=bf)
    w2 = base[1:].view(128, 128).copy_(w[2])
    with pytest.raises(ValueError, match="16-byte"):
        ap.attention_pool_fwd_bf16(feats.to(bf), w[0].to(bf), w[1], w2,
                                   w[3], qm.to(bf), 64)


@pytest.mark.cuda
def test_fused_bag_forward_bf16_on_card(card):
    """The bf16 eval forward through K1-bf16 against the CPU's (which rounds
    the weights per 1024-row tile): the bag logits within 1e-3 of their
    scale, the max instance logits (f32) at 1e-5."""
    from tpumil_torch.models.dsmil import DSMIL, DSMILConfig

    torch.manual_seed(0)
    model = DSMIL(DSMILConfig(feats_size=512, num_classes=2),
                  torch.device("cpu"))
    feats = torch.randn(20000, 512) * 0.5
    want = ap.fused_bag_forward(model, feats, feats_dtype=torch.bfloat16)
    model = model.to(card)
    before = ap.attention_pool_fwd_bf16.launches
    got = ap.fused_bag_forward(model, feats.to(card),
                               feats_dtype=torch.bfloat16)
    assert ap.attention_pool_fwd_bf16.launches == before + 1
    scale = want[0].abs().max().item() + 1.0
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-3 * scale
    _close("max logits", got[1].cpu(), want[1], 1e-5)


@pytest.mark.cuda
def test_trainable_pool_gradients_match_autograd(card):
    """TrainablePool (K1 forward, K2 + K3 backward) against autograd through
    the plain forward."""
    feats, w, qm, db = _pool_inputs(card, 3000, 2900, 512, 2, True, seed=2)
    leaves = [x.clone().requires_grad_(True) for x in [feats, *w, qm]]
    out = ap.TrainablePool.apply(*leaves, 2900, True)
    (out * db).sum().backward()
    got = [x.grad for x in leaves]
    ref = [x.clone().requires_grad_(True) for x in [feats, *w, qm]]
    want_out = ap.attention_pool_plain(*ref, 2900, True)[0]
    (want_out * db).sum().backward()
    _close("B", out.detach(), want_out.detach(), 1e-4)
    for g, x in zip(got, ref):
        _close("grad", g, x.grad, 1e-3)


@pytest.mark.cuda
def test_attention_pool_rejects_bad_cuda_input(card):
    feats, w, qm, _ = _pool_inputs(card, 64, 64, 128, 2, True)
    with pytest.raises(ValueError, match="contiguous"):
        ap.attention_pool_fwd(feats.T.contiguous().T, *w, qm, 64)
    with pytest.raises(ValueError, match="n_valid"):
        ap.attention_pool_fwd(feats, *w, qm, 65)
    with pytest.raises(ValueError, match="classes"):
        ap.attention_pool_fwd(feats, *w, torch.zeros(9, 128, device=card), 64)
    with pytest.raises(ValueError, match="K % 4"):
        ap.attention_pool_fwd(feats[:, :126].contiguous(),
                              w[0][:, :126].contiguous(), *w[1:], qm, 64)
    lg, m, s = torch.zeros(64, 2, device=card), torch.zeros(2, device=card), \
        torch.ones(2, device=card)
    with pytest.raises(ValueError, match="K % 4"):
        ap.attention_pool_bwd1(feats[:, :126].contiguous(), lg, m, s,
                               torch.zeros(2, 126, device=card), 64)
    with pytest.raises(ValueError, match="tensors on cpu"):
        ap.attention_pool_bwd1(feats, lg.cpu(), m, s,
                               torch.zeros(2, 128, device=card), 64)


# -- the training path on the card ---------------------------------------------

@pytest.mark.cuda
def test_trainer_paths_on_card(card):
    """The list path (bags moved per chunk) and the store path agree on the
    card, the kernel route matches the eager one, and patch and value
    dropout draw from CUDA generators."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    rng = np.random.default_rng(3)
    bags = [Bag(rng.standard_normal((n, 64), np.float32),
                np.eye(2, dtype=np.float32)[i % 2], f"b{i}")
            for i, n in enumerate([40, 90, 300, 1200])]  # buckets in order
    store = DeviceBagStore(bags, device=card)
    out = {}
    for name, thr, data in (("list", None, bags), ("store", None, store),
                            ("kernels", 256, store)):
        tr = BagTrainer(DSMILConfig(64, 2), weight_decay=1e-3,
                        fused_threshold=thr, device=card)
        model, opt = tr.init(torch.Generator().manual_seed(0))
        _, _, loss = tr.train_epoch(model, opt, data, 1e-3,
                                    np.random.default_rng(1), shuffle=False)
        out[name] = (loss, tr.predict(model, data)[0])
        assert (tr.fused_dispatches > 0) == (thr is not None)
    for name in ("store", "kernels"):
        np.testing.assert_allclose(out[name][0], out["list"][0], rtol=2e-4)
        np.testing.assert_allclose(out[name][1], out["list"][1], rtol=1e-4,
                                   atol=1e-5)
    for cfg, drop in ((DSMILConfig(64, 2), 0.3),
                      (DSMILConfig(64, 2, passing_v=True, dropout_v=0.2), 0.0)):
        tr = BagTrainer(cfg, dropout_patch=drop, device=card)
        model, opt = tr.init(torch.Generator().manual_seed(0))
        _, _, loss = tr.train_epoch(model, opt, store, 1e-3,
                                    np.random.default_rng(2))
        scores, _ = tr.predict(model, store)
        assert np.isfinite(loss) and np.isfinite(scores).all()
        assert tr.fused_dispatches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [166, 230])
def test_kernel_route_at_any_k_on_card(card, k):
    """The kernel route at the classic MIL widths, K = 166 (musk) and 230
    (elephant, fox, tiger), C = 1, against the eager route through
    BagTrainer from the same init: store views of 664- or 920-byte rows
    start off 16-byte boundaries, so fused_bag_loss and fused_bag_forward
    pad them for K1-K3, which launch."""
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    rng = np.random.default_rng(4)
    bags = [Bag(rng.standard_normal((n, k), np.float32),
                np.asarray([float(i % 2)], np.float32), f"b{i}")
            for i, n in enumerate([5, 17, 9, 300, 1201, 3])]
    store = DeviceBagStore(bags, device=card)
    assert any(store.bag(i).data_ptr() % 16 for i in range(len(bags)))
    kernels = (ap.attention_pool_fwd, ap.attention_pool_bwd1,
               ap.attention_pool_bwd2)
    out = {}
    for thr in (0, None):
        tr = BagTrainer(DSMILConfig(k, 1), weight_decay=1e-3,
                        fused_threshold=thr, device=card)
        tr.pos_weight = np.asarray([1.2], np.float32)
        model, opt = tr.init(torch.Generator().manual_seed(0))
        for fn in kernels:
            fn.launches = 0
        losses = [tr.train_epoch(model, opt, store, 1e-3,
                                 np.random.default_rng(e), shuffle=False)[2]
                  for e in range(2)]
        scores = tr.predict(model, store)[0]
        out[thr] = (losses, {n: v.cpu() for n, v in model.state_dict().items()},
                    scores, [fn.launches for fn in kernels])
    (l_k, p_k, s_k, n_k), (l_e, p_e, s_e, n_e) = out[0], out[None]
    assert min(n_k) > 0 and max(n_e) == 0
    np.testing.assert_allclose(l_k, l_e, rtol=2e-4)
    for name in p_k:
        np.testing.assert_allclose(p_k[name].numpy(), p_e[name].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(s_k, s_e, rtol=1e-4, atol=1e-5)


# -- K5: the ResNet stem (csrc/stem.cu) ----------------------------------------

from tpumil_torch.ops.stem import fused_stem, stem_plain  # noqa: E402


def _stem_inputs(device, b, seed=0):
    """[0, 1) images and kaiming-scaled HWIO stem weights."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((b, 224, 224, 3), np.float32)).to(device)
    w = rng.standard_normal((7, 7, 3, 64)) * np.sqrt(2.0 / (7 * 7 * 64))
    return x, torch.from_numpy(w.astype(np.float32)).to(device)


def _stem_bar(x, w7, want, dtype):
    """f32: atol = rtol = 1e-4 (test_stem_pallas.py's bar; sums in another
    order). bf16: one bf16 step of the conv output, in normalized units
    (|x| * inv <= |out| + |mean| * inv per (image, channel), and its pool
    window's maximum moves by at most that step), plus one bf16 step of the
    output."""
    if dtype == torch.float32:
        return 1e-4 + 1e-4 * want.abs()
    conv = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).to(dtype), w7.permute(3, 2, 0, 1).to(dtype),
        stride=2, padding=3).float()
    mean = conv.mean(dim=(2, 3))
    inv = torch.rsqrt(conv.var(dim=(2, 3), unbiased=False) + 1e-5)
    shift = (mean.abs() * inv)[:, None, None, :]
    return 2 ** -7 * (2 * want.float().abs() + shift) + 1e-6


def _stem_check(x, w7, dtype):
    before = fused_stem.launches
    got = fused_stem(x, w7, dtype)
    torch.cuda.synchronize()
    assert fused_stem.launches == before + 1
    assert got.dtype == dtype and got.shape == (x.shape[0], 56, 56, 64)
    assert got.is_contiguous() and torch.isfinite(got).all()
    want = stem_plain(x, w7, dtype)
    err = (got.float() - want.float()).abs()
    bad = err > _stem_bar(x, w7, want, dtype)
    assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} out of the "
                           f"bar; max abs err {err.max().item():.3e}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_matches_plain(card, dtype):
    x, w7 = _stem_inputs(card, 4)
    got = _stem_check(x, w7, dtype)
    _stem_check(x.to(torch.bfloat16), w7, dtype)   # a bf16 input
    # a contiguous x whose data is not 16-byte aligned (the kernel reads x
    # in 16-byte vectors; the wrapper copies such an x)
    flat = torch.empty(x.numel() + 1, device=card)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert torch.equal(_stem_check(shifted, w7, dtype), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_blank_tiles(card, dtype):
    """A black image gives a constant conv plane: exact zeros, not NaN. A
    white image's plane is not constant (the zero padding reaches the
    border rows and columns); it and near-white and near-black images stay
    within the bar."""
    _, w7 = _stem_inputs(card, 1)
    noise = torch.from_numpy(np.random.default_rng(1).integers(
        0, 3, (1, 224, 224, 3)).astype(np.float32) / 255).to(card)
    x = torch.cat([torch.zeros(1, 224, 224, 3, device=card),
                   torch.ones(1, 224, 224, 3, device=card), 1 - noise, noise])
    got = _stem_check(x, w7, dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def _tile_boundary_images(b, device):
    """Dim [0, 0.1) images crossed by bright input rows and columns that,
    inside a pooled window, only the conv row r0 - 1 of a tile start r0
    (8 conv rows a tile) or the conv column c0 - 1 of a column tile start
    c0 (16 columns) reaches, or reaches first: image k puts them 5 - k % 3
    input rows (columns) before 2 r0 (2 c0). The window's maximum then sits
    on the row the previous tile computes, or on the column the warp to the
    left computes."""
    rng = np.random.default_rng(3)
    x = 0.1 * rng.random((b, 224, 224, 3), np.float32)
    for k in range(b):
        s = -5 + k % 3
        x[k, [2 * r0 + s for r0 in range(8, 112, 8)]] = 1.0
        x[k, :, [2 * c0 + s for c0 in range(16, 112, 16)]] = 1.0
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 128])
def test_stem_kernel_tile_boundary_windows(card, dtype, b):
    _, w7 = _stem_inputs(card, 1)
    x = _tile_boundary_images(b, card)
    got = _stem_check(x, w7, dtype)
    assert torch.equal(fused_stem(x, w7, dtype), got)


@pytest.mark.cuda
def test_stem_kernel_is_deterministic_and_checks_inputs(card):
    x, w7 = _stem_inputs(card, 3, seed=2)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(fused_stem(x, w7, dtype), fused_stem(x, w7, dtype))
    with pytest.raises(ValueError, match="224"):
        fused_stem(x[:, :112, :112].contiguous(), w7, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_stem(x, w7.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0),
                   torch.float32)
    with pytest.raises(ValueError, match="float32"):
        fused_stem(x, w7.to(torch.bfloat16), torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fused_stem(x.to(torch.uint8), w7, torch.float32)


@pytest.mark.cuda
def test_fused_stem_resnet_route(card, monkeypatch):
    """ResNet18-IN at 224^2: one K5 launch and 19 K4 launches per forward,
    features within 1e-4 of the same net with the conv-route stem (conv,
    K4, max pool); at 192^2 the stem is the conv route, 20 K4 launches."""
    from tpumil_torch.models import embedder, resnet

    def conv_route_stem(x, w7, dtype):
        h = resnet._conv(x.permute(0, 3, 1, 2).to(dtype),
                         w7.permute(3, 2, 0, 1), 2, dtype)
        return torch.nn.functional.max_pool2d(
            resnet._instance_norm(h, True), 3, 2, 1).permute(0, 2, 3, 1)

    rng = np.random.default_rng(4)
    model = embedder.init_params(0, embedder.EmbedderConfig(), card)
    imgs = {size: torch.from_numpy(rng.integers(
        0, 256, (4, size, size, 3), np.uint8)).to(card) for size in (224, 192)}
    feats = {}
    for size, want in ((224, (19, 1)), (192, (20, 0))):
        k4, k5 = fused_instance_norm.launches, fused_stem.launches
        with torch.inference_mode():
            feats[size], _ = model(imgs[size])
        torch.cuda.synchronize()
        assert (fused_instance_norm.launches - k4,
                fused_stem.launches - k5) == want
    monkeypatch.setattr(resnet, "fused_stem", conv_route_stem)
    with torch.inference_mode():
        conv, _ = model(imgs[224])
    np.testing.assert_allclose(feats[224].cpu().numpy(), conv.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_bag_inference_on_card(card, tmp_path):
    """BagInference at 224^2 on a bag of 6 patches at batch 4 (the last
    batch ragged): one K5 and 19 K4 launches per batch, and scores,
    attention and instance logits within 1e-4 of the port's CPU path."""
    import os

    from PIL import Image

    from tpumil_torch.cli.attention_map import load_milnet
    from tpumil_torch.infer.heatmap import BagInference
    from tpumil_torch.models import embedder

    rng = np.random.default_rng(5)
    bag = tmp_path / "slide0"
    bag.mkdir()
    for k in range(6):
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), np.uint8)) \
            .save(bag / f"{k // 3}_{2 * (k % 3)}.jpg")
    emb_path = str(tmp_path / "embedder.pth")
    torch.save(embedder.export_embedder_state_dict(embedder.init_params(
        0, embedder.EmbedderConfig(), torch.device("cpu"))), emb_path)
    agg_path = os.path.join(os.path.dirname(__file__), "data",
                            "tcga_aggregator.pth")
    out = {}
    for dev in (card, torch.device("cpu")):
        emb, _, agg, model = load_milnet(emb_path, agg_path, 2, dev)
        infer = BagInference(emb, agg, batch_size=4, num_workers=2,
                             model=model)
        k4, k5 = fused_instance_norm.launches, fused_stem.launches
        out[dev.type] = infer.run_bag(str(bag))
        torch.cuda.synchronize()
        launches = (fused_stem.launches - k5, fused_instance_norm.launches - k4)
        assert launches == ((2, 38) if dev.type == "cuda" else (0, 0))
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["cuda"][3], out["cpu"][3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simclr_step_trains_conv1_on_card(card, dtype):
    """A SimCLR train step at 224^2, where a frozen net would take K5 and
    K4: the trainable net takes the differentiable route, conv1 receives a
    finite, non-zero gradient and moves, and K4/K5 launch 0 times."""
    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.ops.augment import draw_uniforms
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    tr = SimCLRTrainer(SimCLRConfig(compute_dtype=dtype),
                       SimCLRTrainConfig(batch_size=4), device=card)
    model, opt = tr.init(0)
    gen = torch.Generator(device=card).manual_seed(0)
    images = torch.randint(0, 256, (4, 224, 224, 3), dtype=torch.uint8,
                           device=card, generator=gen)
    before = model.backbone.conv1.weight.detach().clone()
    k4, k5 = fused_instance_norm.launches, fused_stem.launches
    loss = tr.train_step(model, opt, draw_uniforms(
        torch.Generator().manual_seed(0), 4), images, 1e-3)
    torch.cuda.synchronize()
    g = model.backbone.conv1.weight.grad
    assert torch.isfinite(loss) and torch.isfinite(g).all()
    assert g.abs().max() > 0
    assert not torch.equal(model.backbone.conv1.weight, before)
    assert (fused_instance_norm.launches - k4, fused_stem.launches - k5) == \
        (0, 0)


COPY_KERNELS = ("copy_kernel", "transpose", "Transpose")
CUDNN_TRANSFORMS = ("nhwcToNchw", "nchwToNhwc")


def _kernel_ns(step):
    """{kernel name: device ns} of one call of ``step`` under
    torch.profiler, after a call outside the trace (cuDNN's plans, the
    allocator's blocks)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ns = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") \
                and not e.name().startswith(("Memcpy", "Memset")) \
                and not (hasattr(e, "is_user_annotation")
                         and e.is_user_annotation()):
            ns[e.name()] = ns.get(e.name(), 0) + e.duration_ns()
    return ns


def _share(ns, keys):
    return sum(v for k, v in ns.items() if any(c in k for c in keys)) \
        / sum(ns.values())


@pytest.mark.cuda
def test_trainable_f32_resnet_runs_without_layout_copies(card, monkeypatch):
    """A trainable f32 ResNet18-IN forward and backward at 224^2, batch 8,
    under torch.profiler. Copies stay the 3-channel input's, each kernel's
    NCHW copy and its gradient's copy back; cuDNN's transforms stay those
    of the NHWC weight-gradient engine its heuristics pick for some of the
    stride-2 convs into the last two stages. The same weights with
    channels_last convs (the layout before the route went NCHW: conv
    outputs NHWC, copied to NCHW inside F.instance_norm and back in its
    backward) are the control that the kernel names see layout copies."""
    import torch.nn.functional as F

    from tpumil_torch.models import resnet
    from tpumil_torch.models.simclr import SimCLRConfig, init_model

    backbone = init_model(0, SimCLRConfig(compute_dtype=torch.float32),
                          card).backbone
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.rand(8, 224, 224, 3, device=card, generator=gen)

    def step():
        backbone.zero_grad(set_to_none=True)
        backbone(x).square().sum().backward()

    route = _kernel_ns(step)

    class ChannelsLastConvs:
        def __getattr__(self, name):
            return getattr(F, name)

        def conv2d(self, x, w, *args, **kwargs):
            cl = torch.channels_last
            return F.conv2d(x.contiguous(memory_format=cl),
                            w.contiguous(memory_format=cl), *args, **kwargs)

    monkeypatch.setattr(resnet, "F", ChannelsLastConvs())
    channels_last = _kernel_ns(step)
    control = _share(channels_last, COPY_KERNELS + CUDNN_TRANSFORMS)
    copies = _share(route, COPY_KERNELS)
    transforms = _share(route, CUDNN_TRANSFORMS)
    assert control > 0.1, control
    assert copies + transforms < 0.05 and transforms < 0.01, \
        (copies, transforms, control)


# -- TransMIL's depthwise convs (csrc/depthwise.cu) ----------------------------

import math  # noqa: E402

from tpumil_torch.ops import depthwise as dw  # noqa: E402

DW_SIZES = [256, 4096, 6758, 65536]  # the cohort's ends, median and mean
DW_TOL = 2e-5  # of the largest float64 value: f32 sums in another order


def _dw_inputs(card, n, seed=0):
    """The two sites at bag size n, published widths: v as a head-split
    view of a [P, 1536] qkv (its front P - T rows zero, as the model pads),
    the PPEG's x [T, 512], their leaves and output gradients."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, device=card, generator=g) * scale

    side = math.isqrt(n - 1) + 1
    t = side * side + 1
    big = 256 * -(-t // 256)
    qkv = rand(big, 1536)
    qkv[:big - t] = 0
    res = {"inputs": [qkv.requires_grad_()],
           "leaves": [rand(8, 1, 33, 1, scale=33 ** -0.5)],
           "dy": rand(t, 512), "t": t}
    ppeg = {"inputs": [rand(t, 512)], "dy": rand(t, 512), "side": side,
            "leaves": [rand(*s, scale=0.1) for k in (7, 5, 3)
                       for s in ((512, 1, k, k), (512,))]}
    return res, ppeg


def _dw_run(fn, site, double=False):
    """Output and gradients [input, *leaves] of one site, through the
    wrapper (the kernels) or, in float64, through its plain version."""
    cast = (lambda t: t.detach().double().requires_grad_()) if double else \
        (lambda t: t.detach().requires_grad_())
    leaves = [cast(w) for w in site["leaves"]]
    base = cast(site["inputs"][0])
    if fn is dw.residual_conv:
        x = base.view(base.shape[0], 3, 8, 64).permute(1, 2, 0, 3)[2]
        plain = dw.residual_conv_plain
        args = (site["t"],)
        call = (lambda x, *w: (plain if double else fn)(x, *w, *args))
    else:
        x = base
        plain = dw.ppeg_plain
        call = (lambda x, *w: (plain if double else fn)(x, site["side"], *w))
    out = call(x, *leaves)
    grads = torch.autograd.grad((out * site["dy"].to(out.dtype)).sum(),
                                [base, *leaves])
    return [out.detach(), *grads]


def _dw_close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= DW_TOL * max(scale, 1e-30), f"{what}: {err} of {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", DW_SIZES)
def test_depthwise_kernels_match_plain(card, n):
    """Forward, input gradient and every leaf's gradient of both sites,
    against the plain versions in float64 (P = 65792 and side = 256 at
    N = 65536); a site's launches: forward, input gradient and the weight
    gradient (the PPEG's as partials and their merge)."""
    res, ppeg = _dw_inputs(card, n)
    for fn, site, names, launches in (
            (dw.residual_conv, res, ["out", "dqkv", "dw"], 3),
            (dw.ppeg, ppeg, ["out", "dx", "dw7", "db7", "dw5", "db5", "dw3",
                             "db3"], 4)):
        before = fn.launches
        got = _dw_run(fn, site)
        torch.cuda.synchronize()
        assert fn.launches == before + launches
        want = _dw_run(fn, site, double=True)
        for name, a, b in zip(names, got, want):
            _dw_close(a, b, f"{fn.__name__} N={n} {name}")


@pytest.mark.cuda
def test_depthwise_kernels_rerun_bitwise(card):
    res, ppeg = _dw_inputs(card, 6758, seed=1)
    for fn, site in ((dw.residual_conv, res), (dw.ppeg, ppeg)):
        first, again = _dw_run(fn, site), _dw_run(fn, site)
        for a, b in zip(first, again):
            assert torch.equal(a, b), fn.__name__


@pytest.mark.cuda
def test_depthwise_refuses_bad_cuda_input(card):
    qkv = torch.randn(512, 1536, device=card)
    v = qkv.view(512, 3, 8, 64).permute(1, 2, 0, 3)[2]
    w = torch.randn(8, 1, 33, 1, device=card)
    with pytest.raises(ValueError, match="float32"):
        dw.residual_conv(v.double(), w.double(), 257)
    with pytest.raises(ValueError, match="tensors on cpu"):
        dw.residual_conv(v, w.cpu(), 257)
    with pytest.raises(ValueError, match="side by side"):
        dw.residual_conv(v.contiguous(), w, 257)
    with pytest.raises(ValueError, match="taps"):
        dw.residual_conv(v, w[:, :, :31].contiguous(), 257)
    x = torch.randn(257, 512, device=card)
    convs = [torch.randn(s, device=card) for k in (7, 5, 3)
             for s in ((512, 1, k, k), (512,))]
    with pytest.raises(ValueError, match="contiguous"):
        dw.ppeg(x.t().contiguous().t(), 16, *convs)
    with pytest.raises(ValueError, match="float32"):
        dw.ppeg(x.half(), 16, *convs)
    with pytest.raises(ValueError, match="tensors on cpu"):
        dw.ppeg(x, 16, *convs[:-1], convs[-1].cpu())


@pytest.mark.cuda
def test_transmil_step_runs_the_depthwise_kernels(card):
    """One BagTrainer step of TransMIL at the published widths: 6 launches
    of the residual conv's kernels (two layers) and 4 of the PPEG's, and no
    ATen depthwise kernel on the device."""
    from torch.profiler import ProfilerActivity, profile

    from tpumil_torch.data.bags import Bag
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    rng = np.random.default_rng(7)
    bags = [Bag(rng.standard_normal((3000, 64), np.float32),
                np.eye(2, dtype=np.float32)[1], "b0")]
    tr = BagTrainer(DSMILConfig(64, 2), model="transmil", device=card)
    model, opt = tr.init(torch.Generator().manual_seed(0))
    tr.train_epoch(model, opt, bags, 2e-4, np.random.default_rng(1))
    before = dw.residual_conv.launches, dw.ppeg.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, loss = tr.train_epoch(model, opt, bags, 2e-4,
                                    np.random.default_rng(2))
        torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert (dw.residual_conv.launches - before[0],
            dw.ppeg.launches - before[1]) == (6, 4)
    names = [e.key for e in prof.key_averages()]
    assert any("dw_band_kernel" in k for k in names)
    assert not any("conv_depthwise2d" in k for k in names)


@pytest.mark.cuda
def test_depthwise_gives_the_references_bits(card):
    """The passes that the plain module runs on ATen's kernels in one order
    give ATen's bits: the residual conv's forward, input gradient and
    weight gradient against ``F.conv2d`` on ``v[None]``, and the PPEG's
    forward against its three convs summed as ((dw7 + x) + dw5) + dw3 (the
    merged 7x7 runs in its backward alone)."""
    import torch.nn.functional as F

    res, ppeg = _dw_inputs(card, 6758, seed=2)
    (qkv,), (w,), t, dy = res["inputs"], res["leaves"], res["t"], res["dy"]
    w = w.requires_grad_()
    v = qkv.view(qkv.shape[0], 3, 8, 64).permute(1, 2, 0, 3)[2]
    want = F.conv2d(v[None], w, padding=(16, 0), groups=8)[0, :, -t:]
    want_grads = torch.autograd.grad(
        want, [qkv, w], dy.view(t, 8, 64).permute(1, 0, 2))
    got = dw.residual_conv(v, w, t)
    assert torch.equal(got, want.transpose(0, 1).reshape(t, -1))
    for a, b in zip(torch.autograd.grad(got, [qkv, w], dy), want_grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        x, side = ppeg["inputs"][0], ppeg["side"]
        w7, b7, w5, b5, w3, b3 = ppeg["leaves"]
        g = x[1:].transpose(0, 1).reshape(1, 512, side, side)
        g = (F.conv2d(g, w7, b7, padding=3, groups=512) + g
             + F.conv2d(g, w5, b5, padding=2, groups=512)
             + F.conv2d(g, w3, b3, padding=1, groups=512))
        want = torch.cat([x[:1], g.reshape(512, -1).transpose(0, 1)])
        assert torch.equal(dw.ppeg(x, side, *ppeg["leaves"]), want)
