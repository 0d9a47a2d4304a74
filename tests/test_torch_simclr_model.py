"""The port's SimCLR models against the JAX package's (tpumil_torch/models/
{simclr,baseline_encoder}.py against tpumil/models/), carried through
tpumil_torch/io/from_jax.py, f32, rtol 1e-4 / atol 1e-4; the SimCLR
checkpoint layout; the differentiable route: a trainable ResNet calls
neither K4 nor K5, whose wrappers refuse a gradient; and the memory format
each route hands F.conv2d and F.instance_norm.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.io import torch_ckpt as jckpt
from tpumil.models import baseline_encoder as jbase
from tpumil.models import embedder as jemb
from tpumil.models import simclr as jsim
from tpumil_torch.io import from_jax, torch_ckpt
from tpumil_torch.models import baseline_encoder, embedder, resnet, simclr
from tpumil_torch.ops import instance_norm, stem

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3)) \
        .astype(np.float32)


def _carried(base_model):
    jcfg = jsim.SimCLRConfig(base_model=base_model, compute_dtype=jnp.float32)
    params = jsim.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = simclr.SimCLRConfig(base_model=base_model,
                              compute_dtype=torch.float32)
    model = simclr.SimCLR(cfg, CPU)
    model.load_state_dict(from_jax.simclr_state_dict(
        jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("base_model,size", [("resnet18", 64),
                                             ("resnet50", 128)])
def test_simclr_forward_matches_jax(base_model, size):
    jcfg, params, cfg, model = _carried(base_model)
    x = _images(2, size)
    h, z = jsim.forward(params, jnp.asarray(x), jcfg)
    th, tz = model(torch.from_numpy(x))
    assert th.shape == (2, cfg.num_ftrs) and tz.shape == (2, 256)
    assert np.abs(np.asarray(z)).max() > 1e-3  # a real comparison
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), **TOL)


def test_resnet50_at_64_is_as_close_to_float64_as_jax():
    """At 64^2 ResNet50's last stage normalizes 2x2 planes, and both
    packages' f32 features lie ~4e-3 from float64 (the 1e-4 bar above
    cannot hold for either): the port's distance to a float64 run of the
    same weights is held to twice the JAX package's."""
    jcfg, params, cfg, model = _carried("resnet50")
    x = _images(2, 64)
    h, z = jsim.forward(params, jnp.asarray(x), jcfg)
    th, tz = model(torch.from_numpy(x))
    ref = simclr.SimCLR(simclr.SimCLRConfig(
        base_model="resnet50", compute_dtype=torch.float64), CPU).double()
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        h64 = ref.backbone(torch.from_numpy(x).double()).double()
        z64 = torch.nn.functional.linear(torch.relu(torch.nn.functional.linear(
            h64, ref.l1.weight, ref.l1.bias)), ref.l2.weight, ref.l2.bias)
    for got, want, exact in ((th, h, h64), (tz, z, z64)):
        port = np.abs(got.detach().double().numpy() - exact.numpy()).max()
        jax_err = np.abs(np.asarray(want, np.float64) - exact.numpy()).max()
        assert port <= 2 * jax_err + 1e-5, (port, jax_err)


def test_base_model_error_matches_jax():
    with pytest.raises(ValueError) as jerr:
        jsim.SimCLRConfig(base_model="resnet34").resnet_cfg
    with pytest.raises(ValueError) as terr:
        simclr.SimCLRConfig(base_model="resnet34").resnet_cfg
    assert str(terr.value) == str(jerr.value)


def test_baseline_encoder_matches_jax():
    params = jbase.init_params(jax.random.PRNGKey(1))
    model = baseline_encoder.BaselineEncoder(CPU)
    model.load_state_dict(from_jax.baseline_encoder_state_dict(
        jax.tree.map(np.asarray, params)))
    x = _images(3, 32, seed=1)
    h, z = jbase.forward(params, jnp.asarray(x))
    th, tz = model(torch.from_numpy(x))
    assert th.shape == (3, 256) and tz.shape == (3, 256)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), **TOL)
    # the port's own init draws the JAX package's distributions
    own = baseline_encoder.BaselineEncoder(CPU).init_params(
        torch.Generator().manual_seed(0))
    for i, w in enumerate(baseline_encoder.WIDTHS):
        std = getattr(own, f"conv{i}").weight.std().item()
        assert abs(std - np.sqrt(2.0 / (9 * w))) < 0.2 * np.sqrt(2.0 / (9 * w))
        assert not getattr(own, f"conv{i}").bias.any()


def test_export_state_dict_has_the_jax_layout(tmp_path):
    """Keys, order, shapes and values of the SimCLR model.pth; it loads
    through both packages' embedder surgery to equal features, and back
    into the port's SimCLR."""
    jcfg, params, cfg, model = _carried("resnet18")
    want = jsim.export_state_dict(params, jcfg)
    got = simclr.export_state_dict(model)
    assert list(got) == list(want)
    assert list(got)[-4:] == list(simclr.HEAD_KEYS)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    path = str(tmp_path / "model.pth")
    torch_ckpt.save_state_dict(got, path)
    x = _images(2, 64, seed=2)
    jcfg_e = jemb.EmbedderConfig(num_classes=1, compute_dtype=jnp.float32)
    jfeats, _ = jemb.forward(jemb.load_simclr_checkpoint(path, jcfg_e),
                             jnp.asarray(x), jcfg_e)
    emb = embedder.load_simclr_checkpoint(path, embedder.EmbedderConfig(
        num_classes=1), CPU)
    with torch.no_grad():
        feats, _ = emb(torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    back = simclr.load_state_dict(simclr.SimCLR(cfg, CPU),
                                  torch_ckpt.load_state_dict(path))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # the JAX package's restore reads the port's checkpoint too
    jback = jsim.load_state_dict(jckpt.load_state_dict(path), jcfg)
    np.testing.assert_array_equal(np.asarray(jback["l2"]["w"]),
                                  np.asarray(params["l2"]["w"]))


def test_kernel_wrappers_refuse_gradients():
    """K4 and K5 write a fresh buffer on the card, with no autograd
    history: a grad-requiring input raises on every device."""
    x = torch.rand(2, 7, 7, 64, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        instance_norm.fused_instance_norm(x)
    with torch.no_grad():
        instance_norm.fused_instance_norm(x)
    img = torch.rand(1, 224, 224, 3)
    w7 = torch.randn(7, 7, 3, 64)
    for a, b in ((img.clone().requires_grad_(), w7),
                 (img, w7.clone().requires_grad_())):
        with pytest.raises(ValueError, match="no backward"):
            stem.fused_stem(a, b, torch.float32)
        with torch.no_grad():
            stem.fused_stem(a, b, torch.float32)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls into the K4 and K5 wrappers from models/resnet.py
    (on the CPU the wrappers' launch counters stay 0: they count kernel
    launches only)."""
    calls = collections.Counter()

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(resnet, "fused_instance_norm",
                        spy("k4", resnet.fused_instance_norm))
    monkeypatch.setattr(resnet, "fused_stem", spy("k5", resnet.fused_stem))
    return calls


def test_trainable_resnet_takes_the_differentiable_route(kernel_calls):
    """At 224^2 a frozen net runs 19 K4 sites and K5; SimCLR's trainable
    net runs neither, in its train and its eval forward, and its conv1
    receives a gradient."""
    x = torch.from_numpy(_images(1, 224, seed=3))
    frozen = embedder.init_params(0, embedder.EmbedderConfig(), CPU)
    with torch.no_grad():
        frozen(x)
    assert (kernel_calls["k4"], kernel_calls["k5"]) == (19, 1)
    kernel_calls.clear()
    model = simclr.init_model(0, simclr.SimCLRConfig(
        compute_dtype=torch.float32), CPU)
    x2 = torch.cat([x, x.flip(2)])
    # every forward turns TF32 off for cuDNN and matmul, backward included
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _, z = model(x2)
    assert not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)
    (z[0] - z[1]).square().sum().backward()
    with torch.no_grad():
        model(x2)
    assert (kernel_calls["k4"], kernel_calls["k5"]) == (0, 0)
    g = model.backbone.conv1.weight.grad
    assert torch.isfinite(g).all() and g.abs().max() > 0
    # the same weights frozen take the kernels again: the route is the
    # weights' requires_grad, not the grad mode
    model.requires_grad_(False)
    with torch.no_grad():
        model(x2)
    assert (kernel_calls["k4"], kernel_calls["k5"]) == (19, 1)


CL = torch.channels_last


def _nhwc(t):
    """channels_last memory and not NCHW-contiguous (a 1x1 kernel is both)"""
    return t.is_contiguous(memory_format=CL) and not t.is_contiguous()


class _FunctionalSpy:
    """torch.nn.functional as models/resnet.py sees it: records what
    F.conv2d, F.instance_norm and F.max_pool2d receive. With
    ``channels_last`` it hands F.conv2d its input and weight in
    channels_last memory, the layout the trainable f32 route ran in before
    it went NCHW (conv outputs channels_last, copied to NCHW inside
    F.instance_norm)."""

    def __init__(self, channels_last=False):
        self.channels_last = channels_last
        self.convs, self.norms, self.pools = [], [], []

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def conv2d(self, x, w, *args, **kwargs):
        if self.channels_last:
            x = x.contiguous(memory_format=CL)
            w = w.contiguous(memory_format=CL)
        out = torch.nn.functional.conv2d(x, w, *args, **kwargs)
        self.convs.append((x, w, out))
        return out

    def instance_norm(self, x, *args, **kwargs):
        self.norms.append(x)
        return torch.nn.functional.instance_norm(x, *args, **kwargs)

    def max_pool2d(self, x, *args, **kwargs):
        out = torch.nn.functional.max_pool2d(x, *args, **kwargs)
        self.pools.append((x, out))
        return out


class _ReluMasks:
    """torch as models/resnet.py sees it, whose relu records which units
    pass (``replay`` False) or passes the recorded ones (``replay`` True).
    A second run that replays the first's masks passes its gradient through
    the same units: an activation within rounding of 0 cannot land on the
    other side of a ReLU kink, where it would pass or stop its whole
    gradient, and rounding alone separates the two runs."""

    def __init__(self):
        self.masks, self.replay = [], False

    def __getattr__(self, name):
        return getattr(torch, name)

    def relu(self, x):
        if self.replay:
            return torch.where(self.masks.pop(0), x, 0.0)
        self.masks.append(x > 0)
        return torch.relu(x)


def _features_and_conv1_grad(backbone, x):
    backbone.zero_grad(set_to_none=True)
    h = backbone(x)
    weights = torch.linspace(-1, 1, h.numel()).reshape(h.shape)
    (h * weights).sum().backward()
    return h.detach(), backbone.conv1.weight.grad.clone()


@pytest.mark.parametrize("case", ["trainable_f32", "trainable_bf16",
                                  "frozen_f32"])
def test_resnet_memory_format_follows_route_and_dtype(case, kernel_calls,
                                                      monkeypatch):
    """ResNet18-IN at 224^2, as F.conv2d and F.instance_norm see it from
    models/resnet.py. A trainable f32 net hands all 20 convs and all 20 IN
    sites NCHW-contiguous tensors, kernels included, and its features and
    conv1 gradient match the channels_last run of the same weights. A
    trainable bf16 net keeps channels_last kernels and conv outputs. The
    same f32 weights frozen run K5 and 19 K4 sites on NHWC views (the conv
    outputs' permutes), and hand the convs the stored kernels themselves."""
    dtype = torch.bfloat16 if case == "trainable_bf16" else torch.float32
    backbone = simclr.init_model(0, simclr.SimCLRConfig(compute_dtype=dtype),
                                 CPU).backbone
    x = torch.from_numpy(_images(2, 224, seed=5))
    spy = _FunctionalSpy()
    monkeypatch.setattr(resnet, "F", spy)
    if case == "frozen_f32":
        backbone.requires_grad_(False)
        with torch.no_grad():
            backbone(x)
        assert (kernel_calls["k4"], kernel_calls["k5"]) == (19, 1)
        assert len(spy.convs) == 19 and not spy.norms and not spy.pools
        stored = {p.data_ptr() for p in backbone.parameters()}
        for xin, w, out in spy.convs:
            assert _nhwc(xin) and _nhwc(out)
            assert w.data_ptr() in stored  # the stored kernel, not a copy
        return
    relu = _ReluMasks()
    monkeypatch.setattr(resnet, "torch", relu)
    h, g = _features_and_conv1_grad(backbone, x)
    assert len(relu.masks) == 17  # the stem, and two in each block
    assert len(spy.convs) == 20 and len(spy.norms) == 20
    assert len(spy.pools) == 1
    if case == "trainable_bf16":
        for xin, w, out in spy.convs:
            assert w.is_contiguous(memory_format=CL) and _nhwc(out)
            assert _nhwc(w) or w.shape[2:] == (1, 1)
        assert all(_nhwc(t) for t in spy.norms)
        return
    for conv in spy.convs:
        assert all(t.is_contiguous() for t in conv)
    assert all(t.is_contiguous() for t in spy.norms)
    assert all(a.is_contiguous() and b.is_contiguous() for a, b in spy.pools)
    # the same weights with channels_last convs, through the same ReLU
    # masks, agree to f32 rounding (a flipped kink alone moves conv1's
    # gradient by ~3e-3 of its norm at batch 2)
    monkeypatch.setattr(resnet, "F", _FunctionalSpy(channels_last=True))
    relu.replay = True
    h_cl, g_cl = _features_and_conv1_grad(backbone, x)
    assert not relu.masks
    np.testing.assert_allclose(h.numpy(), h_cl.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert (g - g_cl).norm() <= 1e-4 * g_cl.norm()
