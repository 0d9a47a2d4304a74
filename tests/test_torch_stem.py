"""The port's fused ResNet stem (tpumil_torch/ops/stem.py; on the CPU its
plain version) against the JAX package's ``fused_stem`` (Pallas, interpret
mode) and ``xla_stem``, and the port's ResNet18, whose stem at 224^2 is
``fused_stem``, against its conv-route stem and the JAX ResNet, all on the
same numpy inputs. Two tests pin on the CPU what the Hopper kernel
(csrc/stem.cu) rests on: pooling the raw conv before normalizing gives the
plain stem's bits, and its 3xTF32 product meets the f32 bar where one TF32
pass does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from tpumil.models import embedder as jemb
from tpumil.ops.stem_pallas import fused_stem as jax_fused_stem
from tpumil.ops.stem_pallas import xla_stem
from tpumil_torch.io import from_jax
from tpumil_torch.models import embedder, resnet
from tpumil_torch.ops.instance_norm import EPS, instance_norm_plain
from tpumil_torch.ops.stem import fused_stem, stem_plain

CPU = torch.device("cpu")
# tests/test_stem_pallas.py's bar: the same sums in another order
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(weights: str, b: int = 2, seed: int = 0):
    """test_stem_pallas.py's two cases: kaiming weights on [0, 1) images,
    and 0.1-scale weights on standard-normal inputs."""
    rng = np.random.default_rng(seed)
    if weights == "kaiming":
        w = rng.standard_normal((7, 7, 3, 64)) * np.sqrt(2.0 / (7 * 7 * 64))
        x = rng.random((b, 224, 224, 3))
    else:
        w = 0.1 * rng.standard_normal((7, 7, 3, 64))
        x = rng.standard_normal((b, 224, 224, 3))
    return x.astype(np.float32), w.astype(np.float32)


def _port(x, w, dtype):
    return fused_stem(torch.from_numpy(x), torch.from_numpy(w), dtype)


@pytest.mark.parametrize("weights", ["kaiming", "0.1"])
def test_stem_matches_jax_f32(weights):
    x, w = _inputs(weights)
    got = _port(x, w, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 56, 56, 64)
    assert got.is_contiguous()
    pallas = jax_fused_stem(jnp.asarray(x), jnp.asarray(w),
                            compute_dtype=jnp.float32, interpret=True)
    xla = xla_stem(jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.float32)
    assert np.abs(np.asarray(xla)).max() > 1.0  # a real comparison
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blank_images(dtype):
    """A black image's conv plane is constant: exact zeros, not NaN. A
    white image's is not (the zero padding reaches the border), and it
    matches the JAX stem. Its plane is constant inside the border, so the
    normalization multiplies the conv's f32 rounding by |mean| / std, up to
    20 here: the bar is 10x the random-image bar."""
    _, w = _inputs("kaiming")
    black = _port(np.zeros((1, 224, 224, 3), np.float32), w, dtype)
    assert torch.equal(black, torch.zeros_like(black))
    white = np.ones((1, 224, 224, 3), np.float32)
    got = _port(white, w, dtype).float()
    assert torch.isfinite(got).all() and got.abs().max() > 1.0
    if dtype == torch.float32:
        want = xla_stem(jnp.asarray(white), jnp.asarray(w),
                        compute_dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=1e-3)


def test_bad_inputs_raise():
    _, w = _inputs("kaiming")
    wt = torch.from_numpy(w)
    with pytest.raises(ValueError, match="224"):
        fused_stem(torch.zeros(1, 112, 112, 3), wt, torch.float32)
    with pytest.raises(ValueError, match="HWIO"):
        fused_stem(torch.zeros(1, 224, 224, 3), wt.permute(3, 2, 0, 1),
                   torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fused_stem(torch.zeros(1, 224, 224, 3, dtype=torch.uint8), wt,
                   torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fused_stem(torch.zeros(1, 224, 224, 3), wt, torch.float16)


def test_resnet_routes_the_stem_by_norm_and_size(monkeypatch):
    """ResNet's stem is K5 for instance norm at 224^2 and the conv route
    (conv, IN or BN, max pool) for every input K5 does not take."""
    calls = []

    def counting(x, w7, dtype):
        calls.append(tuple(x.shape))
        return fused_stem(x, w7, dtype)

    monkeypatch.setattr(resnet, "fused_stem", counting)
    for norm, size, want in (("instance", 224, 1), ("instance", 64, 0),
                             ("batch", 224, 0)):
        calls.clear()
        model = embedder.init_params(0, embedder.EmbedderConfig(norm=norm),
                                     CPU)
        with torch.inference_mode():
            feats, _ = model(torch.zeros(1, size, size, 3, dtype=torch.uint8))
        assert feats.shape == (1, 512) and len(calls) == want, (norm, size)


def test_bf16_tier_error_is_within_twice_the_jax_tiers():
    """bf16 against the f32 stem: the port's relative L2 error at most 2x
    the JAX bf16 stem's (the ROADMAP Queue 3 method: bf16 convolutions
    round differently on different hosts)."""
    x, w = _inputs("kaiming")
    ref = np.asarray(xla_stem(jnp.asarray(x), jnp.asarray(w),
                              compute_dtype=jnp.float32))
    jax_bf16 = np.asarray(xla_stem(jnp.asarray(x), jnp.asarray(w),
                                   compute_dtype=jnp.bfloat16), np.float32)
    got = _port(x, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16

    def rel(a):
        return np.linalg.norm(a - ref) / np.linalg.norm(ref)

    assert 0 < rel(got.float().numpy()) <= 2 * rel(jax_bf16)


def conv_route_stem(x, w7, dtype):
    """The stem as ResNet runs it for inputs K5 does not take (conv, IN +
    ReLU, max pool), with fused_stem's NHWC/HWIO signature."""
    h = resnet._conv(x.permute(0, 3, 1, 2).to(dtype), w7.permute(3, 2, 0, 1),
                     2, dtype)
    return F.max_pool2d(resnet._instance_norm(h, True), 3, 2, 1) \
        .permute(0, 2, 3, 1)


def test_resnet18_fused_stem_route_matches_default_and_jax(monkeypatch):
    """ResNet18-IN at 224^2 (its stem through fused_stem) against the same
    net with the conv-route stem and against the JAX ResNet."""
    cfg_j = jemb.EmbedderConfig(backbone="resnet18", norm="instance",
                                num_classes=2, compute_dtype=jnp.float32,
                                precision="highest")
    params = jemb.init_params(jax.random.PRNGKey(0), cfg_j)
    x = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3), np.uint8)
    want, _ = jemb.forward(params, jnp.asarray(x), cfg_j)
    cfg = embedder.EmbedderConfig(num_classes=2)
    model = embedder.Embedder(cfg, CPU)
    model.load_state_dict(from_jax.embedder_state_dict(
        params, cfg.resnet_cfg), strict=True)
    feats = {}
    with torch.inference_mode():
        feats["k5"], _ = model(torch.from_numpy(x))
        monkeypatch.setattr(resnet, "fused_stem", conv_route_stem)
        feats["conv"], _ = model(torch.from_numpy(x))
    assert np.abs(np.asarray(want)).max() > 0.1  # a real comparison
    np.testing.assert_allclose(feats["k5"].numpy(), feats["conv"].numpy(),
                               **TOL)
    np.testing.assert_allclose(feats["k5"].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_first_order_is_the_plain_stem(dtype):
    """The kernel's order: max-pool the raw conv values (rounded to the
    compute dtype), then normalize the maximum, apply ReLU and round.
    Normalizing with rsqrt > 0, ReLU and rounding are monotone
    non-decreasing, so this is bit for bit the plain stem, which normalizes
    every value first. The statistics are instance_norm_plain's."""
    x, w = _inputs("kaiming")
    white = np.ones((1, 224, 224, 3), np.float32)
    for img in (x, white):
        xt, wt = torch.from_numpy(img), torch.from_numpy(w)
        conv = F.conv2d(xt.permute(0, 3, 1, 2).to(dtype),
                        wt.permute(3, 2, 0, 1).to(dtype), stride=2, padding=3)
        h = conv.permute(0, 2, 3, 1).float()
        mean = h.mean(dim=(1, 2), keepdim=True)
        var = (h - mean).square().mean(dim=(1, 2), keepdim=True)
        pooled = F.max_pool2d(h.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                              padding=1).permute(0, 2, 3, 1)
        got = torch.relu((pooled - mean) * torch.rsqrt(var + EPS)).to(dtype)
        want = stem_plain(xt, wt, dtype)
        assert got.abs().max() > 1.0  # a real comparison
        assert torch.equal(got, want)


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds (finite values)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_conv(x: np.ndarray, w: np.ndarray, passes: int) -> np.ndarray:
    """The f32 conv as the kernel's tensor cores compute it: the 147 taps in
    kh-major (HWIO) order padded to 152 with zero weights, in k8 steps; each
    operand split x = hi + lo in TF32 (hi = tf32(x), lo = tf32(x - hi));
    per step the products lo*hi + hi*lo + hi*hi (passes=3, 3xTF32) or hi*hi
    alone (passes=1, single-pass TF32) into a fresh sum (exact products, the
    sum in float64, rounded to f32), folded into the f32 sum by an f32 add.
    Returns [B, 112, 112, 64] f32."""
    b = x.shape[0]
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    cols = np.stack([xp[:, kh:kh + 224:2, kw:kw + 224:2, :]
                     for kh in range(7) for kw in range(7)], axis=3)
    cols = np.pad(cols.reshape(-1, 147), ((0, 0), (0, 5)))
    wk = np.pad(w.reshape(147, 64), ((0, 5), (0, 0)))
    ah, bh = _tf32(cols), _tf32(wk)
    al, bl = _tf32(cols - ah), _tf32(wk - bh)
    acc = np.zeros((cols.shape[0], 64), np.float32)
    for k in range(0, 152, 8):
        s = slice(k, k + 8)
        prods = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
        step = sum(a[:, s].astype(np.float64) @ c[s].astype(np.float64)
                   for a, c in prods)
        acc = acc + step.astype(np.float32)
    return acc.reshape(b, 112, 112, 64)


def _stem_from_conv(conv: np.ndarray) -> np.ndarray:
    h = instance_norm_plain(torch.from_numpy(conv), relu=True)
    return F.max_pool2d(h.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                        padding=1).permute(0, 2, 3, 1).numpy()


def test_3xtf32_conv_is_within_the_f32_bar():
    """The kernel's f32 stream on the tensor cores, emulated in numpy: the
    3xTF32 stem is within TOL of xla_stem in f32 on both weight cases,
    while single-pass TF32 misses that bar on at least one, so the bar
    tells the two apart."""
    single_pass_misses = []
    for weights in ("kaiming", "0.1"):
        x, w = _inputs(weights)
        want = np.asarray(xla_stem(jnp.asarray(x), jnp.asarray(w),
                                   compute_dtype=jnp.float32))
        got = _stem_from_conv(_emulated_conv(x, w, passes=3))
        np.testing.assert_allclose(got, want, **TOL)
        one = _stem_from_conv(_emulated_conv(x, w, passes=1))
        single_pass_misses.append(not np.allclose(one, want, **TOL))
    assert any(single_pass_misses)
