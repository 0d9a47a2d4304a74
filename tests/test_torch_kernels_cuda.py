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
                                            instance_norm_plain)

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
    another order (blocks of 32 rows, then a fixed-order merge)."""
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
    rows, one row, up to the 8-class bound."""
    feats, w, qm, db = _pool_inputs(card, n, n_valid, k, c, nonlinear)
    counts = (ap.attention_pool_fwd.launches, ap.attention_pool_bwd1.launches,
              ap.attention_pool_bwd2.launches)
    out, m, s = ap.attention_pool_fwd(feats, *w, qm, n_valid, nonlinear)
    torch.cuda.synchronize()
    want_out, want_m, want_s = ap.attention_pool_plain(feats, *w, qm, n_valid,
                                                       nonlinear)
    _close("B", out, want_out, 1e-4)
    _close("m", m, want_m, 1e-5)
    _close("s", s, want_s, 1e-4)
    s_red = ap.attention_pool_bwd1(feats, *w, qm, want_m, want_s, db, n_valid,
                                   nonlinear)
    torch.cuda.synchronize()
    want_red = ap.attention_pool_bwd1_plain(feats, *w, qm, want_m, want_s, db,
                                            n_valid, nonlinear)
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


@pytest.mark.cuda
def test_attention_pool_kernels_are_deterministic(card):
    feats, w, qm, db = _pool_inputs(card, 20000, 19999, 512, 2, True, seed=1)
    runs = []
    for _ in range(2):
        out, m, s = ap.attention_pool_fwd(feats, *w, qm, 19999)
        red = ap.attention_pool_bwd1(feats, *w, qm, m, s, db, 19999)
        runs.append((out, red) + ap.attention_pool_bwd2(
            feats, *w, qm, m, s, db, red, 19999))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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
    want_out, _, _ = ap.attention_pool_plain(*ref, 2900, True)
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
    _stem_check(x, w7, dtype)
    _stem_check(x.to(torch.bfloat16), w7, dtype)   # a bf16 input


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
