"""The port's ResNet embedder (tpumil_torch/models/{resnet,embedder}.py)
against the JAX package, with the same weights carried over by
tpumil_torch/io/from_jax.py.

Inputs are 64^2: at 32^2 ResNet's last stage is 1x1, where instance norm
outputs exactly 0 and the pooled features are all zero on both sides, which
would compare nothing.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil_torch.io import from_jax
from tpumil_torch.models import embedder, resnet

CPU = torch.device("cpu")
PATCH = 64
# features after ~20 normalizations summed in another order (the
# test_in_pallas.py:54 forward-parity bar)
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


class _FusedEmbCfg:
    """EmbedderConfig proxy that sets ResNetConfig.fused_in (the JAX
    EmbedderConfig is frozen and has no field for it)."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    @property
    def resnet_cfg(self):
        return dataclasses.replace(self._base.resnet_cfg, fused_in=True)


def _jax_setup(backbone, norm, s2d=False, seed=0):
    cfg = jemb.EmbedderConfig(backbone=backbone, norm=norm, num_classes=2,
                              compute_dtype=jnp.float32, precision="highest",
                              space_to_depth=s2d)
    params = jemb.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    if norm == "batch":  # non-trivial running statistics to fold
        bb = dict(params["backbone"])
        for k, v in bb.items():
            if k.endswith("running_var"):
                bb[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32)
            elif k.endswith(("running_mean", "bias")) and v.ndim == 1:
                bb[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.1,
                                    jnp.float32)
            elif k.endswith("weight") and v.ndim == 1:
                bb[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
        params = dict(params, backbone=bb)
    params = jemb.set_head(params,
                           rng.standard_normal((2, cfg.num_feats)) * 0.05,
                           rng.standard_normal((2,)) * 0.1)
    return cfg, params


def _port(cfg_j, params, backbone, norm, s2d=False):
    cfg = embedder.EmbedderConfig(backbone=backbone, norm=norm, num_classes=2,
                                  precision="f32", space_to_depth=s2d)
    model = embedder.Embedder(cfg, CPU)
    model.load_state_dict(from_jax.embedder_state_dict(params, cfg.resnet_cfg),
                          strict=True)
    return model


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, PATCH, PATCH, 3),
                                                np.uint8)


# ResNet50 runs at 128^2: its 2048-wide last stage normalizes 4x4 planes,
# which amplify summation-order noise; the JAX package's own jit and eager
# forwards differ by 1.1e-4 there (3.5e-3 at 64^2, 2x2 planes).
BOTTLENECK_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("backbone,norm,fused_in,s2d", [
    ("resnet18", "instance", False, False),
    ("resnet18", "instance", True, False),   # Pallas IN in interpret mode
    ("resnet18", "batch", False, False),
    ("resnet50", "instance", False, False),
    ("resnet18", "instance", False, True),   # space-to-depth stem
])
def test_embedder_matches_jax(backbone, norm, fused_in, s2d):
    cfg_j, params = _jax_setup(backbone, norm, s2d)
    bottleneck = backbone == "resnet50"
    x = np.random.default_rng(0).integers(0, 256, (1, 128, 128, 3), np.uint8) \
        if bottleneck else _images(3)
    tol = BOTTLENECK_TOL if bottleneck else FEAT_TOL
    fj, lj = jemb.forward(params, jnp.asarray(x),
                          _FusedEmbCfg(cfg_j) if fused_in else cfg_j)
    model = _port(cfg_j, params, backbone, norm, s2d)
    with torch.inference_mode():
        ft, lt = model(torch.from_numpy(x))
    assert ft.dtype == torch.float32 and ft.shape == (len(x), cfg_j.num_feats)
    assert np.abs(np.asarray(fj)).max() > 0.1  # a real comparison
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **tol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)


def test_uint8_is_divided_on_device_like_float_input():
    """uint8 in -> /255 on the device, bitwise the same as feeding the f32
    [0, 1] images."""
    cfg_j, params = _jax_setup("resnet18", "instance")
    model = _port(cfg_j, params, "resnet18", "instance")
    x = _images(2, seed=5)
    with torch.inference_mode():
        fu, lu = model(torch.from_numpy(x))
        ff, lf = model(torch.from_numpy(x.astype(np.float32) / 255.0))
    np.testing.assert_array_equal(fu.numpy(), ff.numpy())
    np.testing.assert_array_equal(lu.numpy(), lf.numpy())


def test_space_to_depth_stem_matches_plain_stem():
    """Same math as the 7x7/s2 stem, another summation order."""
    cfg_j, params = _jax_setup("resnet18", "instance")
    plain = _port(cfg_j, params, "resnet18", "instance", s2d=False)
    s2d = _port(cfg_j, params, "resnet18", "instance", s2d=True)
    x = torch.from_numpy(_images(2, seed=6))
    with torch.inference_mode():
        np.testing.assert_allclose(s2d(x)[0].numpy(), plain(x)[0].numpy(),
                                   **FEAT_TOL)


def test_state_dict_names_follow_torchvision_order():
    from tpumil.models import resnet as jresnet

    for depth, norm in ((18, "instance"), (18, "batch"), (34, "instance"),
                        (50, "instance"), (101, "batch")):
        cfg = resnet.ResNetConfig(depth=depth, norm=norm)
        model = resnet.ResNet(cfg, CPU)
        assert list(model.state_dict()) == resnet.param_names(cfg)
        assert resnet.param_names(cfg) == jresnet.param_names(
            jresnet.ResNetConfig(depth=depth, norm=norm))
        assert model.cfg.num_feats == (512 if depth < 50 else 2048)
    names = resnet.param_names(resnet.ResNetConfig(depth=18, norm="batch"))
    assert names[:6] == ["conv1.weight", "bn1.weight", "bn1.bias",
                         "bn1.running_mean", "bn1.running_var",
                         "layer1.0.conv1.weight"]
    assert "layer2.0.downsample.1.running_var" in names


def _jax_export(tmp_path, params, cfg_j, extra_head=False):
    sd = jemb.export_embedder_state_dict(params, cfg_j)
    if extra_head:  # a raw SimCLR checkpoint: 4 projection-MLP tensors
        sd = collections.OrderedDict(sd)
        rng = np.random.default_rng(9)
        sd["l1.weight"] = rng.standard_normal((512, 512)).astype(np.float32)
        sd["l1.bias"] = np.zeros(512, np.float32)
        sd["l2.weight"] = rng.standard_normal((128, 512)).astype(np.float32)
        sd["l2.bias"] = np.zeros(128, np.float32)
    path = str(tmp_path / ("model.pth" if extra_head else "embedder.pth"))
    jckpt.save_state_dict(sd, path)
    return path, sd


@pytest.mark.parametrize("extra_head", [False, True])
def test_checkpoint_surgery_matches_jax(tmp_path, extra_head):
    """JAX export -> .pth -> port load_simclr_checkpoint gives the same
    tensors, for a surgered export and for a raw checkpoint with the +4
    projection head; the port's export round-trips the same bytes."""
    cfg_j, params = _jax_setup("resnet18", "instance", seed=3)
    path, sd = _jax_export(tmp_path, params, cfg_j, extra_head)
    cfg = embedder.EmbedderConfig(backbone="resnet18", num_classes=2)
    model = embedder.load_simclr_checkpoint(path, cfg, CPU)
    exported = embedder.export_embedder_state_dict(model)
    want = jemb.export_embedder_state_dict(params, cfg_j)
    assert list(exported) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(exported[k].numpy(), v)
    # the head is zero after a checkpoint load, as in the reference
    assert not model.fc.weight.any() and not model.fc.bias.any()
    # and the JAX loader reads the port's export back to the same params
    out = str(tmp_path / "port_export.pth")
    torch.save(exported, out)
    back = jemb.load_simclr_checkpoint(out, cfg_j)
    for k, v in params["backbone"].items():
        np.testing.assert_array_equal(np.asarray(back["backbone"][k]),
                                      np.asarray(v))


def test_checkpoint_surgery_rejects_bad_counts(tmp_path):
    cfg_j, params = _jax_setup("resnet18", "instance")
    sd = jemb.export_embedder_state_dict(params, cfg_j)
    sd = collections.OrderedDict(list(sd.items())[:-2])  # truncated
    path = str(tmp_path / "short.pth")
    jckpt.save_state_dict(sd, path)
    cfg = embedder.EmbedderConfig(backbone="resnet18")
    with pytest.raises(ValueError, match="expected exactly"):
        embedder.load_simclr_checkpoint(path, cfg, CPU)
    with pytest.raises(ValueError, match="truncated"):
        embedder.load_simclr_checkpoint(path, cfg, CPU, strip_head=False)


def test_batchnorm_torchvision_checkpoint_loads_by_name(tmp_path):
    """A torchvision-style BN checkpoint (num_batches_tracked entries)
    loads by name, matching the JAX loader's result."""
    cfg_j, params = _jax_setup("resnet18", "batch", seed=4)
    sd = from_jax.resnet_state_dict(params["backbone"], cfg_j.resnet_cfg)
    tv = collections.OrderedDict()
    for k, v in sd.items():
        tv[k] = v
        if k.endswith("running_var"):
            tv[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    path = str(tmp_path / "tv.pth")
    torch.save(tv, path)
    cfg = embedder.EmbedderConfig(backbone="resnet18", norm="batch")
    model = embedder.load_simclr_checkpoint(path, cfg, CPU)
    got = model.feature_extractor.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())


def test_seeded_init_is_reproducible_and_kaiming():
    cfg = embedder.EmbedderConfig(backbone="resnet18")
    a = embedder.init_params(0, cfg, CPU).state_dict()
    b = embedder.init_params(0, cfg, CPU).state_dict()
    c = embedder.init_params(1, cfg, CPU).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["feature_extractor.conv1.weight"],
                           c["feature_extractor.conv1.weight"])
    w = a["feature_extractor.layer4.1.conv2.weight"]
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() - np.sqrt(2.0 / fan_out)) < 0.05 * np.sqrt(
        2.0 / fan_out)
    assert not a["fc.weight"].any()


def test_precision_table_pins_true_f32():
    """f32 / f32h / f32x are true f32 with TF32 off for cuDNN and matmul;
    bf16 is bf16 activations; no tier allows TF32."""
    assert embedder.PRECISION_FLAGS == {
        "bf16": torch.bfloat16,
        "f32": torch.float32,
        "f32h": torch.float32,
        "f32x": torch.float32,
    }
    with pytest.raises(ValueError, match="precision"):
        embedder.precision_from_flag("tf32")
    cfg = embedder.EmbedderConfig(backbone="resnet18", precision="f32")
    assert cfg.resnet_cfg.compute_dtype == torch.float32
    model = embedder.init_params(0, cfg, CPU)
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.inference_mode():
            model(torch.from_numpy(_images(1)))
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def test_bf16_tier_keeps_bf16_activations_and_f32_outputs():
    cfg_j, params = _jax_setup("resnet18", "instance")
    cfg = embedder.EmbedderConfig(backbone="resnet18", num_classes=2,
                                  precision="bf16")
    assert cfg.resnet_cfg.compute_dtype == torch.bfloat16
    model = embedder.Embedder(cfg, CPU)
    model.load_state_dict(from_jax.embedder_state_dict(params, cfg.resnet_cfg))
    seen = []
    hook = model.feature_extractor.layer1[0].register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.inference_mode():
        feats, logits = model(torch.from_numpy(_images(2)))
    hook.remove()
    assert seen == [torch.bfloat16]
    assert feats.dtype == torch.float32 and logits.dtype == torch.float32
    # parameters stay f32
    assert model.feature_extractor.conv1.weight.dtype == torch.float32
    x = jnp.asarray(_images(2))
    fj, _ = jemb.forward(params, x, cfg_j)
    # The JAX package's own bf16 tier on the same weights and images rounds
    # at the same points. bf16 CPU convolutions accumulate differently on
    # different CPUs, so an elementwise bar against the f32 oracle depends on
    # the host; the ratio of the two tiers' errors does not.
    cfg_bf = dataclasses.replace(cfg_j, compute_dtype=jnp.bfloat16,
                                 precision="default")
    fj_bf, _ = jemb.forward(params, x, cfg_bf)
    ref = np.asarray(fj, np.float64)
    port_err = _rel_l2(feats.numpy(), ref)
    jax_err = _rel_l2(np.asarray(fj_bf, np.float32), ref)
    assert 0.0 < jax_err < 0.5, jax_err  # the JAX tier really is bf16
    assert port_err <= 2.0 * jax_err, (port_err, jax_err)


def _rel_l2(x, ref):
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / np.linalg.norm(ref))
