"""The ``tcga-transmil`` cell on the CPU at a small size (its traffic,
configuration and the program's TransMIL width cut here): a sound run
comes out correct, a run with a fault planted underneath the timed path
does not, a program without TransMIL fails at once; the FLOP count of
``transmil_mfu_pct`` against PyTorch's counter."""

from __future__ import annotations

import json
import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, copy_checkout
from portbench import harness, run
from portbench.reference import transmil as ref

CPU = torch.device("cpu")
CELL = "tcga-transmil"
SMALL_TRAFFIC = {"bags": 6, "median": 48, "min": 8, "max": 120, "feats": 16}
SMALL_ARCH = {"hidden_dim": 32, "heads": 4, "head_dim": 8, "landmarks": 8}


@pytest.fixture
def small(tmp_path, monkeypatch):
    from tpumil_torch.models import transmil

    root = copy_checkout(tmp_path / "checkout")
    spec_path = root / "portbench" / "workloads" / f"{CELL}.json"
    spec = json.loads(spec_path.read_text())
    spec["traffic"].update(SMALL_TRAFFIC)
    spec_path.write_text(json.dumps(spec))
    cfg_path = root / "portbench" / "configs" / "transmil-tcga-nsclc.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["aggregator"].update(SMALL_ARCH, feats_size=16)
    cfg_path.write_text(json.dumps(cfg))
    monkeypatch.setattr(transmil, "ARCH", transmil.TransMILArch(
        dim=32, heads=4, landmarks=8))
    return root


def _run(root, trace=False):
    return run.run_cell(root, CELL, 2 ** 31 + 7, 0.2, trace, CPU,
                        time.perf_counter())


def test_sound_run_is_correct(small):
    res = _run(small)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s"}  # the rest reads the card's
    res = _run(small, trace=True)
    assert res["correct"]
    assert res["metrics"]["transmil_mfu_pct.transmil"]["value"] > 0


def _half_bag(monkeypatch):
    from tpumil_torch.models import transmil

    fwd = transmil.TransMIL.forward
    monkeypatch.setattr(transmil.TransMIL, "forward", lambda self, f, *a, **k:
                        fwd(self, f[: max(f.shape[0] // 2, 1)], *a, **k))


FAULTS = {
    "state unchanged": lambda mp: mp.setattr(
        torch.optim.RAdam, "step", lambda self, closure=None: None),
    "half the bag": _half_bag,
    "dropout skipped": lambda mp: mp.setattr(
        __import__("tpumil_torch.models.transmil", fromlist=["x"]),
        "dropout", lambda x, p, g: x),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(small, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(small)
    assert not res["correct"], res["compared"]


def test_a_program_without_transmil_fails_at_once(small, monkeypatch):
    from tpumil_torch.models import registry

    monkeypatch.delitem(registry._MODELS, "transmil")
    t0 = time.perf_counter()
    with pytest.raises(harness.BenchError, match="transmil"):
        _run(small)
    assert time.perf_counter() - t0 < 30


@pytest.mark.parametrize("n,k,c,d,h,m", [(30, 12, 2, 32, 4, 8),
                                         (50, 6, 3, 16, 2, 5)])
def test_step_flops_against_the_counter(n, k, c, d, h, m):
    mfu = harness.metric_reader(REPO, "transmil_mfu_pct.transmil")
    p = {name: v.requires_grad_() for name, v in ref.make_params(
        k, c, torch.Generator().manual_seed(0), "cpu", dim=d,
        heads=h).items()}
    f = torch.rand(n, k)
    with FlopCounterMode(display=False) as fwd:
        loss = ref.loss(p, f, torch.eye(c)[0], None, landmarks=m, p_drop=0.0)
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    def by_op(counter):
        return {str(o): v for o, v in
                counter.get_flop_counts()["Global"].items()}

    # the counter takes a grouped convolution's weight gradient as a full
    # convolution over the input's channels: groups times its work. Its
    # excess, all depthwise: the PPEG's three over the d channels of the
    # H x H grid, and each layer's residual convolution over its h heads
    side = math.isqrt(n - 1) + 1
    rows = m * -(-(side * side + 1) // m)
    over = (d - 1) * 2 * d * side * side * (49 + 25 + 9) \
        + 2 * (h - 1) * 2 * h * rows * (d // h) * 33
    conv_fwd = by_op(fwd)["aten.convolution"]
    assert by_op(bwd)["aten.convolution_backward"] - over == 2 * conv_fwd
    counted = fwd.get_total_flops() + bwd.get_total_flops() - over
    assert mfu.step_flops(n, k, c, d, h, m, 6, 33) == counted
