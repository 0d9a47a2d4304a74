"""The port's fused ResNet stem (tpumil_torch/ops/stem.py; on the CPU its
plain version) against the JAX package's ``fused_stem`` (Pallas, interpret
mode) and ``xla_stem``, and the port's ResNet18, whose stem at 224^2 is
``fused_stem``, against its conv-route stem and the JAX ResNet, all on the
same numpy inputs.
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
from tpumil_torch.ops.stem import fused_stem

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
