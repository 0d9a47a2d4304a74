"""The port's DSMIL aggregator and masked ops (tpumil_torch/models/dsmil.py,
tpumil_torch/ops/masked.py) against the reference's golden outputs and the
JAX package's forward."""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.models import dsmil as jdsmil
from tpumil.models.dsmil import DSMILConfig as JDSMILConfig
from tpumil.ops import masked as jmasked
from tpumil_torch.io import from_jax, torch_ckpt
from tpumil_torch.models import dsmil
from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
from tpumil_torch.models.registry import get_model
from tpumil_torch.ops import masked

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
# both sides are true f32; sums run in another order
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,num_classes", [("c16", 1), ("tcga", 2)])
def test_golden_aggregator_outputs(name, num_classes):
    """The shipped .pth loads strict=True and reproduces the reference's
    outputs at tests/test_golden.py's tolerances."""
    golden = np.load(os.path.join(DATA, "golden_aggregator.npz"))
    model, cfg, model_name = torch_ckpt.load_mil_pth(
        os.path.join(DATA, f"{name}_aggregator.pth"), CPU)
    assert model_name == "dsmil" and cfg.num_classes == num_classes
    sd = torch.load(os.path.join(DATA, f"{name}_aggregator.pth"),
                    weights_only=True)
    assert list(model.state_dict()) == list(sd)
    with torch.inference_mode():
        c, bag_logits, attn, _ = model(torch.from_numpy(golden[f"{name}_feats"]))
    np.testing.assert_allclose(bag_logits.numpy()[None],
                               golden[f"{name}_bag_logits"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), golden[f"{name}_attention"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), golden[f"{name}_ins_logits"],
                               rtol=1e-4, atol=1e-5)


def _padded_batch(k, c, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [20, 13, 1, 0]   # the last bag is all padding
    n = max(lengths)
    feats = rng.standard_normal((len(lengths), n, k)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    logits = rng.standard_normal((len(lengths), n, c)).astype(np.float32)
    return feats, mask, logits


@pytest.mark.parametrize("nonlinear,passing_v,with_logits", [
    (True, False, False),
    (False, False, False),
    (True, True, False),
    (True, False, True),
])
def test_forward_matches_jax(nonlinear, passing_v, with_logits):
    k, c = 32, 2
    jcfg = JDSMILConfig(feats_size=k, num_classes=c, nonlinear=nonlinear,
                        passing_v=passing_v)
    params = jdsmil.init_params(jax.random.PRNGKey(3), jcfg)
    # non-zero biases so every parameter matters
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda v: v + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                       if v.ndim == 1 else 0), params)
    feats, mask, logits = _padded_batch(k, c)
    ins = logits if with_logits else None
    want = jdsmil.forward(params, jnp.asarray(feats), jnp.asarray(mask),
                          ins_logits=None if ins is None else jnp.asarray(ins))
    model = DSMIL(DSMILConfig(feats_size=k, num_classes=c, nonlinear=nonlinear,
                              passing_v=passing_v), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(mask),
                    ins_logits=None if ins is None else torch.from_numpy(ins))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    attn = got[2].numpy()
    assert np.all(attn[~mask] == 0.0)          # padded rows get exactly 0
    assert np.all(attn[3] == 0.0)              # the all-padding bag
    np.testing.assert_allclose(attn[:3].sum(axis=1), 1.0, rtol=1e-6)


def test_unpadded_bag_equals_its_padded_form():
    """The service aggregates bags unpadded; that matches the masked padded
    forward of the JAX package to float tolerance."""
    k, c = 32, 2
    params = jdsmil.init_params(jax.random.PRNGKey(5),
                                JDSMILConfig(feats_size=k, num_classes=c))
    model = DSMIL(DSMILConfig(feats_size=k, num_classes=c), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params))
    feats = np.random.default_rng(6).standard_normal((11, k)).astype(np.float32)
    padded = np.zeros((16, k), np.float32)
    padded[:11] = feats
    mask = np.arange(16) < 11
    want = jdsmil.forward(params, jnp.asarray(padded), jnp.asarray(mask))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2])[:11], **TOL)


def test_masked_ops_ties_and_padding_match_jax():
    x = np.asarray([[1.0, 3.0, 3.0, 0.5],
                    [2.0, 2.0, 2.0, 2.0],
                    [5.0, 1.0, 5.0, 9.0],
                    [4.0, 4.0, 4.0, 4.0]], np.float32)
    mask = np.asarray([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0], [0, 0, 0, 0]],
                      bool)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    am = masked.masked_argmax(tx, tm, dim=1).numpy()
    np.testing.assert_array_equal(am, [1, 0, 0, 0])  # ties -> lowest index
    np.testing.assert_array_equal(
        am, np.asarray(jmasked.masked_argmax(jnp.asarray(x), jnp.asarray(mask),
                                             axis=1)))
    mx = masked.masked_max(tx, tm, dim=1).numpy()
    np.testing.assert_array_equal(mx, np.float32([3.0, 2.0, 5.0, -1e30]))
    sm = masked.masked_softmax(tx, tm, dim=1).numpy()
    np.testing.assert_allclose(
        sm, np.asarray(jmasked.masked_softmax(jnp.asarray(x), jnp.asarray(mask),
                                              axis=1)), rtol=1e-6, atol=1e-7)
    assert np.all(sm[3] == 0.0) and np.all(np.isfinite(sm))
    # trailing-feature-dim mask broadcasting ([B, N] mask on [B, N, C])
    x3 = np.stack([x, -x], axis=-1)
    np.testing.assert_array_equal(
        masked.masked_argmax(torch.from_numpy(x3), tm, dim=1).numpy(),
        np.asarray(jmasked.masked_argmax(jnp.asarray(x3), jnp.asarray(mask),
                                         axis=1)))


@pytest.mark.parametrize("average", [False, True])
def test_bag_scores_average_is_the_undivided_sum(average):
    k, c = 32, 2
    params = jdsmil.init_params(jax.random.PRNGKey(7),
                                JDSMILConfig(feats_size=k, num_classes=c))
    params["i_fc"]["b"] = params["i_fc"]["b"] + 3.0  # push the sum past 1
    model = DSMIL(DSMILConfig(feats_size=k, num_classes=c), CPU)
    model.load_state_dict(from_jax.dsmil_state_dict(params))
    feats, mask, _ = _padded_batch(k, c, seed=8)
    feats, mask = feats[:3], mask[:3]
    want = jdsmil.bag_scores(params, jnp.asarray(feats), jnp.asarray(mask),
                             average=average)
    with torch.inference_mode():
        got = dsmil.bag_scores(model, torch.from_numpy(feats),
                               torch.from_numpy(mask), average=average)
        c_, bag_logits, _, _ = model(torch.from_numpy(feats),
                                     torch.from_numpy(mask))
        manual = torch.sigmoid(bag_logits)
        if average:
            manual = manual + torch.sigmoid(
                dsmil.max_instance_logits(c_, torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy(), manual.numpy())
    if average:
        assert got.max().item() > 1.0  # summed, not averaged


@pytest.mark.parametrize("spelling", ["fc.0", "fc"])
def test_load_mil_pth_accepts_both_i_classifier_spellings(tmp_path, spelling):
    sd = torch.load(os.path.join(DATA, "tcga_aggregator.pth"),
                    weights_only=True)
    if spelling == "fc":
        sd = collections.OrderedDict(
            (k.replace("i_classifier.fc.0.", "i_classifier.fc."), v)
            for k, v in sd.items())
    path = str(tmp_path / "agg.pth")
    torch.save(sd, path)
    model, cfg, _ = torch_ckpt.load_mil_pth(path, CPU)
    assert cfg == DSMILConfig(feats_size=512, num_classes=2)
    w = sd.get("i_classifier.fc.0.weight", sd.get("i_classifier.fc.weight"))
    assert torch.equal(model.i_classifier.fc[0].weight, w)
    assert not model.training


def test_registry_and_unported_schemas(tmp_path):
    """Every registry name is a model now; the pooling schema loads."""
    from tpumil_torch.models.abmil import ABMIL
    from tpumil_torch.models.poolmil import MaxPool, MeanPool
    from tpumil_torch.models.transmil import TransMIL

    assert get_model("dsmil") is DSMIL
    for name, cls in (("abmil", ABMIL), ("meanpool", MeanPool),
                      ("maxpool", MaxPool), ("transmil", TransMIL)):
        assert get_model(name) is cls
    with pytest.raises(ValueError, match="unknown"):
        get_model("no-such-model")
    path = str(tmp_path / "pool.pth")
    torch.save({"i_classifier.fc.weight": torch.zeros(2, 8),
                "i_classifier.fc.bias": torch.zeros(2),
                "pooling.mode": torch.tensor(1.0)}, path)
    model, cfg, name = torch_ckpt.load_mil_pth(path, CPU)
    assert name == "maxpool" and isinstance(model, MaxPool)
    assert cfg == DSMILConfig(feats_size=8, num_classes=2)


def test_strip_projection_head_drops_last_four():
    sd = collections.OrderedDict((f"k{i}", torch.zeros(1)) for i in range(7))
    assert list(torch_ckpt.strip_projection_head(sd)) == ["k0", "k1", "k2"]
