"""Each plain reference against float64 at a tiny size, and the
references against the port where both should compute the same thing
(the tests may import the port; the references may not)."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import augment as ref_augment
from portbench.reference import compare as cmp
from portbench.reference import dsmil as ref_dsmil
from portbench.reference import resnet as ref_resnet
from portbench.reference import simclr as ref_simclr


def _f64(p):
    return {k: v.double() for k, v in p.items()}


def test_dsmil_loss_and_gradient_against_float64():
    p = ref_dsmil.make_params(32, 2, 16, torch.Generator().manual_seed(1),
                              "cpu")
    f = torch.rand(50, 32, generator=torch.Generator().manual_seed(2))
    y = torch.tensor([0.0, 1.0])
    l32 = ref_dsmil.loss(p, f, y)
    l64 = ref_dsmil.loss(_f64(p), f.double(), y.double())
    assert float(l32) == pytest.approx(float(l64), rel=1e-6)
    leaves = {k: v.double().requires_grad_() for k, v in p.items()}
    l64 = ref_dsmil.loss(leaves, f.double(), y.double())
    g64 = torch.autograd.grad(l64, list(leaves.values()))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    g32 = torch.autograd.grad(ref_dsmil.loss(leaves, f, y),
                              list(leaves.values()))
    for a, b in zip(g32, g64):
        assert torch.allclose(a.double(), b, rtol=1e-4, atol=1e-6)


def test_dsmil_reference_against_the_port():
    from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
    from tpumil_torch.ops.losses import dual_stream_loss

    p = ref_dsmil.make_params(32, 2, 128, torch.Generator().manual_seed(3),
                              "cpu")
    model = DSMIL(DSMILConfig(32, 2), torch.device("cpu"))
    model.load_state_dict(p)
    f = torch.rand(40, 32, generator=torch.Generator().manual_seed(4))
    y = torch.tensor([1.0, 0.0])
    c, bag, _, _ = model(f)
    port = dual_stream_loss(bag, c.max(dim=0).values, y)
    assert float(port) == pytest.approx(float(ref_dsmil.loss(p, f, y)),
                                        rel=1e-6)


def test_adam_against_torch():
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(5))
    p_torch = w.clone().requires_grad_()
    opt = torch.optim.Adam([p_torch], lr=1e-3, betas=(0.5, 0.9),
                           weight_decay=1e-2)
    params = {"w": w.clone()}
    mine = ref_dsmil.Adam(params, 1e-3, (0.5, 0.9), 1e-8, 1e-2)
    for step in range(3):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(step))
        p_torch.grad = g.clone()
        opt.step()
        mine.step(params, {"w": g})
    assert torch.allclose(params["w"], p_torch.detach(), rtol=1e-6,
                          atol=1e-7)


def test_resnet_against_float64():
    w = ref_resnet.make_weights(torch.Generator().manual_seed(6), "cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(7))
    a = ref_resnet.forward(w, x)
    b = ref_resnet.forward(_f64(w), x.double(), torch.float64)
    assert torch.allclose(a.double(), b, rtol=1e-4, atol=1e-5)


def test_resnet_reference_against_the_port():
    from tpumil_torch.models.embedder import Embedder, EmbedderConfig

    w = ref_resnet.make_weights(torch.Generator().manual_seed(8), "cpu")
    model = Embedder(EmbedderConfig(), torch.device("cpu"))
    model.feature_extractor.load_state_dict(w)
    x = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(9))
    feats, _ = model(x)
    assert torch.allclose(feats, ref_resnet.features(w, x), rtol=1e-4,
                          atol=1e-5)


def test_augment_copy_is_the_port_bitwise():
    from tpumil_torch.ops import augment as port

    u = torch.rand((2, 4, ref_augment.N_UNIFORMS),
                   generator=torch.Generator().manual_seed(10))
    img = torch.rand(4, 48, 48, 3, generator=torch.Generator().manual_seed(11))
    for dt in (torch.float32, torch.bfloat16):
        a = ref_augment.augment_pair_batch(img, u, 32, dt)
        b = port.augment_pair_batch(img, u, 32, dt)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_nt_xent_against_float64_and_the_port():
    from tpumil_torch.ops.nt_xent import nt_xent_loss

    g = torch.Generator().manual_seed(12)
    z1, z2 = torch.randn(6, 8, generator=g), torch.randn(6, 8, generator=g)
    a = ref_simclr.nt_xent(z1, z2, 0.5)
    b = ref_simclr.nt_xent(z1.double(), z2.double(), 0.5)
    assert float(a) == pytest.approx(float(b), rel=1e-6)
    assert float(a) == pytest.approx(float(nt_xent_loss(z1, z2, 0.5)),
                                     rel=1e-6)


def test_blocked_gradient_is_the_whole_batch_gradient():
    p = ref_simclr.make_params(torch.Generator().manual_seed(13), "cpu")
    imgs = torch.randint(0, 256, (4, 40, 40, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(14))
    u = torch.rand((2, 4, ref_augment.N_UNIFORMS),
                   generator=torch.Generator().manual_seed(15))
    l4, g4 = ref_simclr.loss_and_grads(_f64(p), imgs, u, 0.5, torch.float64,
                                       4)
    l1, g1 = ref_simclr.loss_and_grads(_f64(p), imgs, u, 0.5, torch.float64,
                                       1)
    # the augmentation sums its products in f32, per image but in batches
    # of another size, so the views agree to f32 rounding
    assert l4 == pytest.approx(l1, rel=1e-7)
    for k in g4:
        assert float((g4[k] - g1[k]).norm()) <= 1e-5 * float(g1[k].norm())


def test_leaf_gaps():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 0.0}
    # a tiny leaf is measured against the median leaf, not itself
    assert cmp.worst_leaf_gap(got, want) == pytest.approx(0.1)
    assert cmp.moving_leaves(want) == ["a", "b"]
    assert cmp.worst_relative([1.0, 2.0], [1.0, 2.2]) == pytest.approx(
        0.2 / 2.2)
