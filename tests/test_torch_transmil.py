"""The port's TransMIL (models/transmil.py) against the plain reference
(tests/transmil_reference.py) on the CPU, at small widths: logits, loss,
every leaf's gradient and seven Lookahead(RAdam) steps; N a square and
not, the padded length T a multiple of the landmarks and not; dropout
replayed from a generator, and the faults the comparison has to see;
``train_wsi --model transmil`` with its checkpoints; the spans.

Tolerances: the port computes the attention for the last T rows only and
reorders no sum the reference makes, so on the CPU the two agree to f32
rounding; 1e-5 relative (1e-6 absolute for values near 0) leaves room for
the backward's different accumulation order of the sliced products."""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

import transmil_reference as ref
from tpumil_torch.cli import train_wsi
from tpumil_torch.data import feature_store
from tpumil_torch.data.bags import Bag
from tpumil_torch.io import torch_ckpt
from tpumil_torch.models import transmil as tm
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.registry import get_model
from tpumil_torch.train.trainer import BagTrainer
from tpumil_torch.utils import prof

CPU = torch.device("cpu")
K, C = 12, 2
RTOL, ATOL = 1e-5, 1e-6


def _arch(landmarks=8, iters=6):
    return tm.TransMILArch(dim=32, heads=4, landmarks=landmarks,
                           pinv_iterations=iters)


def _model(arch, seed=1):
    p = ref.make_params(K, C, torch.Generator().manual_seed(seed), "cpu",
                        dim=arch.dim, heads=arch.heads)
    model = tm.TransMIL(DSMILConfig(K, C), CPU, arch)
    model.load_state_dict(p)
    return model, p


def _close(got, want):
    scale = float(want.abs().max())
    return torch.allclose(got, want, rtol=RTOL, atol=ATOL * max(scale, 1.0))


def _port_loss_and_grads(model, f, y, seed):
    model.train()
    model.zero_grad(set_to_none=True)
    _, logits, _, _ = model(f, dropout_generator=torch.Generator()
                            .manual_seed(seed))
    loss = torch.nn.functional.cross_entropy(logits[None], y.argmax()[None])
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad for n, p in model.named_parameters()}


def _ref_loss_and_grads(p, f, y, seed, arch):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    logits = ref.forward(leaves, f, torch.Generator().manual_seed(seed),
                         p_drop=arch.dropout, landmarks=arch.landmarks,
                         iters=arch.pinv_iterations)
    loss = torch.nn.functional.cross_entropy(logits[None], y.argmax()[None])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits.detach(), loss.detach(), dict(zip(leaves, grads))


# (N, landmarks): T = ceil(sqrt(N))^2 + 1 against the landmark count
SHAPES = {"square, T a multiple": (9, 10),      # H 3, T 10
          "not square, T a multiple": (8, 10),  # H 3, T 10
          "square, T not a multiple": (36, 8),  # H 6, T 37, P 40
          "not square, T not a multiple": (30, 8)}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_logits_loss_and_gradients_match_the_reference(case):
    n, m = SHAPES[case]
    arch = _arch(landmarks=m)
    model, p = _model(arch)
    g = torch.Generator().manual_seed(3)
    f, y = torch.rand(n, K, generator=g), torch.tensor([0.0, 1.0])
    lg, loss, grads = _port_loss_and_grads(model, f, y, seed=7)
    rlg, rloss, rgrads = _ref_loss_and_grads(p, f, y, 7, arch)
    assert _close(lg, rlg) and _close(loss, rloss)
    assert set(grads) == set(rgrads)
    for name in rgrads:
        assert _close(grads[name], rgrads[name]), name
    # dropout is on: another draw gives other logits
    lg2, _, _ = _port_loss_and_grads(model, f, y, seed=8)
    assert not _close(lg2, rlg)


@pytest.mark.parametrize("fault", ["dropout skipped",
                                   "five pseudo-inverse iterations"])
def test_the_comparison_sees_a_fault(fault):
    arch = _arch()
    model, p = _model(arch if fault == "dropout skipped" else _arch(iters=5))
    f, y = torch.rand(30, K, generator=torch.Generator().manual_seed(4)), \
        torch.tensor([1.0, 0.0])
    if fault == "dropout skipped":
        model.eval()
        _, logits, _, _ = model(f)
    else:
        logits, _, _ = _port_loss_and_grads(model, f, y, seed=7)
    rlg, _, _ = _ref_loss_and_grads(p, f, y, 7, arch)
    assert not _close(logits, rlg)


def test_nystrom_attention_at_a_multiple_of_the_landmarks():
    arch = _arch(landmarks=8)
    _, p = _model(arch)
    attn = tm.NystromAttention(arch, CPU)
    attn.load_state_dict({k[len("layer1.attn."):]: v for k, v in p.items()
                          if k.startswith("layer1.attn.")})
    attn.eval()
    x = torch.rand(16, arch.dim, generator=torch.Generator().manual_seed(5))
    pp = {k[len("layer1.attn."):]: v for k, v in p.items()
          if k.startswith("layer1.attn.")}
    want = ref.nystrom(pp, x, arch.heads, 8, 6, 0.0, None)
    assert _close(attn(x, None), want)


def _bags(n_bags, rng, sizes=(17, 32)):
    out = []
    for i in range(n_bags):
        n = int(rng.integers(*sizes))
        label = np.zeros(C, np.float32)
        label[i % C] = 1.0
        out.append(Bag(rng.random((n, K), dtype=np.float32), label, f"b{i}"))
    return out


def test_seven_steps_through_the_lookahead_sync(monkeypatch):
    """BagTrainer's steps (one bucket: one dropout generator) against the
    reference's Lookahead(RAdam): RAdam's unadapted steps 1-5, its adapted
    steps 6-7, and the slow weights' pull at step 6."""
    arch = _arch()
    monkeypatch.setattr(tm, "ARCH", arch)
    bags = _bags(7, np.random.default_rng(0))
    trainer = BagTrainer(DSMILConfig(K, C), weight_decay=1e-2,
                         model="transmil", device=CPU)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    lr = 2e-3
    rng = np.random.default_rng(11)
    _, _, mean_loss = trainer.train_epoch(model, opt, bags, lr, rng,
                                          shuffle=False)
    seed = int(np.random.default_rng(11).integers(1 << 62))
    g = torch.Generator().manual_seed(seed)
    ropt = ref.LookaheadRAdam(p, lr, weight_decay=1e-2)
    losses = []
    for bag in bags:
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = ref.loss(leaves, torch.from_numpy(bag.feats),
                        torch.from_numpy(bag.label), g,
                        landmarks=arch.landmarks)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        ropt.step(p, grads)
    assert opt.steps == 7
    assert mean_loss == pytest.approx(np.mean(losses), rel=RTOL)
    for name, value in model.state_dict().items():
        assert _close(value, p[name]), name
    # the sync moved the fast weights to the slow ones, as the reference
    for s, (name, _) in zip(opt.slow, model.named_parameters()):
        assert _close(s, ropt.slow[name]), name


def test_registry_objective_and_refusals():
    assert get_model("transmil") is tm.TransMIL
    trainer = BagTrainer(DSMILConfig(K, C), model="transmil", device=CPU)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    assert type(opt).__name__ == "Lookahead" and opt.k == 6
    assert isinstance(opt.base, torch.optim.RAdam)
    assert opt.base.defaults["decoupled_weight_decay"]
    bags = _bags(3, np.random.default_rng(1))
    scores, losses = trainer.predict(model, bags)
    np.testing.assert_allclose(scores.sum(1), 1.0, rtol=1e-6)  # softmax
    assert np.all(losses > 0)
    with pytest.raises(ValueError, match="transmil"):
        trainer.predict(model, bags, average=True)
    with pytest.raises(ValueError, match="float32"):
        BagTrainer(DSMILConfig(K, C, compute_dtype=torch.bfloat16),
                   model="transmil", device=CPU)


def test_train_wsi_transmil_and_its_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tm, "ARCH", tm.TransMILArch(dim=16, heads=2,
                                                    landmarks=4))
    root = tmp_path / "datasets" / "synth"
    rows = []
    for i, bag in enumerate(_bags(10, np.random.default_rng(2), (4, 20))):
        cls = int(np.argmax(bag.label))
        bag.feats[:, 0] += 2.0 * cls  # separable: most folds save weights
        path = str(root / f"c{cls}" / f"b{i}.csv")
        feature_store.write_bag_csv(bag.feats, path)
        rows.append(f"{path},{cls}")
    with open(root / "synth.csv", "w") as f:
        f.write("0,label\n" + "\n".join(rows) + "\n")
    monkeypatch.chdir(tmp_path)
    assert train_wsi.main(["--device", "cpu", "--dataset", "synth",
                           "--model", "transmil", "--num_classes", "2",
                           "--feats_size", str(K), "--num_epochs", "2",
                           "--lr", "2e-4", "--weight_decay", "1e-5"]) == 0
    assert "Final results: Mean Accuracy" in capsys.readouterr().out
    (day,) = os.listdir(tmp_path / "weights")
    save_dir = tmp_path / "weights" / day
    # a fold writes weights once its score beats 0
    saved = sorted(glob.glob(str(save_dir / "fold_?.pth")))
    assert saved
    for path in saved:
        model, cfg, name = torch_ckpt.load_mil_pth(path, CPU)
        assert name == "transmil"
        assert (cfg.feats_size, cfg.num_classes) == (K, C)
        assert model.arch.dim == 16 and model.arch.heads == 2
        with open(path[:-len(".pth")] + ".json") as f:
            assert len(json.load(f)) == C
    sd = torch_ckpt.load_state_dict(saved[0])
    assert list(sd)[:2] == ["cls_token", "pos_layer.proj.weight"]
    assert "layer2.attn.res_conv.weight" in sd and "_fc2.bias" in sd
    torch_ckpt.save_mil_pth(model, str(tmp_path / "again.pth"), "transmil")
    again, _, _ = torch_ckpt.load_mil_pth(str(tmp_path / "again.pth"), CPU)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with pytest.raises(ValueError, match="transmil"):
        train_wsi.main(["--device", "cpu", "--dataset", "synth", "--model",
                        "transmil", "--average"])


def test_spans_of_a_forward():
    arch = _arch()
    model, _ = _model(arch)
    f = torch.rand(30, K, generator=torch.Generator().manual_seed(6))
    prof.collect()
    model(f)  # recorder off: nothing recorded
    assert prof.collect() == []
    with prof.recording():
        model(f)
    names = [s.name for s in prof.collect()]
    assert set(names) == {"transmil.embed", "transmil.pad", "transmil.layer",
                          "transmil.nystrom", "transmil.landmarks",
                          "transmil.pinv", "transmil.ppeg", "transmil.head"}
    assert names.count("transmil.layer") == 2
    assert names.count("transmil.pinv") == 2


def test_the_two_reference_copies_agree():
    from portbench.reference import transmil as bench_ref

    with open(ref.__file__) as a, open(bench_ref.__file__) as b:
        assert a.read() == b.read()
    p = ref.make_params(K, C, torch.Generator().manual_seed(9), "cpu",
                        dim=16, heads=2)
    q = bench_ref.make_params(K, C, torch.Generator().manual_seed(9), "cpu",
                              dim=16, heads=2)
    f, y = torch.rand(20, K), torch.tensor([1.0, 0.0])
    assert torch.equal(
        ref.loss(p, f, y, torch.Generator().manual_seed(1), landmarks=4),
        bench_ref.loss(q, f, y, torch.Generator().manual_seed(1),
                       landmarks=4))


def test_train_mil_transmil(tmp_path, monkeypatch, capsys):
    """One binary logit: the cross-entropy is BCE, the score a sigmoid, and
    the fold's pos_weight applies."""
    from tpumil_torch.cli import train_mil

    monkeypatch.setattr(tm, "ARCH", tm.TransMILArch(dim=16, heads=2,
                                                    landmarks=4))
    monkeypatch.chdir(tmp_path)
    musk = os.path.join(os.path.dirname(__file__), "data", "musk1_mini.svm")
    assert train_mil.main(["--device", "cpu", "--data_file", musk,
                           "--num_feats", "166", "--cv_fold", "3",
                           "--num_epoch", "1", "--model", "transmil"]) == 0
    out = capsys.readouterr().out
    assert out.count("optimal accuracy") == 3
    assert "Cross validation accuracy mean" in out


def test_lookahead_state_round_trips(tmp_path, monkeypatch):
    """A mid-fold train state (train_wsi --fold_state_every) holds the
    Lookahead's slow weights and count: the resumed run takes the same
    steps, through the sync at step 6."""
    from tpumil_torch.io import native_ckpt

    monkeypatch.setattr(tm, "ARCH", tm.TransMILArch(dim=16, heads=2,
                                                    landmarks=4))
    trainer = BagTrainer(DSMILConfig(K, C), weight_decay=1e-2,
                         model="transmil", device=CPU)
    f, y = torch.rand(10, K), torch.tensor([1.0, 0.0])
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    trainer._train_bags(model, opt, [(f, y)] * 3, False,
                        torch.Generator().manual_seed(0))
    path = str(tmp_path / "state")
    native_ckpt.save_train_state(path, {"params": model.state_dict(),
                                        "opt_state": opt.state_dict()})
    state, _ = native_ckpt.load_train_state(path)
    again, opt2 = trainer.init(torch.Generator().manual_seed(1))
    again.load_state_dict(state["params"])
    opt2.load_state_dict(state["opt_state"])
    for net, o in ((model, opt), (again, opt2)):
        trainer._train_bags(net, o, [(f, y)] * 4, False,
                            torch.Generator().manual_seed(5))
    assert opt.steps == opt2.steps == 7
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
