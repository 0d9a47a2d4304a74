"""The span recorder of utils/prof.py and the spans of the bag and SimCLR
trainers: off by default and then one shared object that records nothing;
on, the same losses and parameters bit for bit, the spans nested as the
trainers' phases are, and stamped on the profiler's clock."""

import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpumil_torch.data.bags import Bag
from tpumil_torch.data.device_store import DeviceBagStore
from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.simclr import SimCLRConfig
from tpumil_torch.ops.augment import draw_uniforms
from tpumil_torch.train.simclr_trainer import SimCLRTrainConfig, SimCLRTrainer
from tpumil_torch.train.trainer import BagTrainer
from tpumil_torch.utils import prof

CPU = torch.device("cpu")
K = 8
SIZES = (5, 7, 7, 12, 20, 20, 33)
CLOCK_US = 20  # span against profiler event, the two clocks' agreement


@pytest.fixture(autouse=True)
def _clean():
    prof.collect()
    yield
    prof.collect()


def _children(spans):
    """span id -> names of its children."""
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s.name)
    return out


def test_off_is_one_shared_no_op():
    assert prof.span("a") is prof.span("b")
    with prof.span("a"):
        with prof.span("b"):
            pass
    assert prof.collect() == []
    with prof.recording():
        with prof.recording():  # nested: still on after the inner block
            pass
        assert prof.span("c") is not prof.span("c")
    assert prof.span("d") is prof.span("e")


def test_parents_are_per_thread():
    def worker():
        with prof.span("worker"):
            pass

    with prof.recording():
        with prof.span("main") as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with prof.span("inner"):
                pass
    assert not t.is_alive()
    spans = {s.name: s for s in prof.collect()}
    assert set(spans) == {"main", "inner", "worker"}
    assert spans["inner"].parent == outer.id == spans["main"].id
    assert spans["main"].parent == 0 and spans["worker"].parent == 0
    assert spans["worker"].tid != spans["main"].tid
    assert spans["main"].start_ns <= spans["inner"].start_ns \
        <= spans["inner"].end_ns <= spans["main"].end_ns
    assert prof.collect() == []  # collect clears


def _bag_epoch(path, on):
    rng = np.random.default_rng(0)
    bags = []
    for i, n in enumerate(SIZES):
        label = np.zeros(2, np.float32)
        label[i % 2] = 1.0
        bags.append(Bag(rng.standard_normal((n, K)).astype(np.float32),
                        label, f"b{i}"))
    data = DeviceBagStore(bags, device=CPU) if path == "store" else bags
    tr = BagTrainer(DSMILConfig(K, 2), weight_decay=1e-3, chunk_size=3,
                    min_bucket=8, device=CPU)
    model, opt = tr.init(torch.Generator().manual_seed(0))
    if on:
        with prof.recording():
            _, _, loss = tr.train_epoch(model, opt, data, 1e-3,
                                        np.random.default_rng(1))
    else:
        _, _, loss = tr.train_epoch(model, opt, data, 1e-3,
                                    np.random.default_rng(1))
    return loss, model.state_dict(), prof.collect()


@pytest.mark.parametrize("path", ["store", "list"])
def test_bag_epoch_spans(path):
    loss, params, spans = _bag_epoch(path, on=False)
    assert spans == []
    loss_on, params_on, spans = _bag_epoch(path, on=True)
    assert loss_on == loss
    for k, v in params.items():
        assert torch.equal(params_on[k], v), k
    count = Counter(s.name for s in spans)
    buckets = count["train.bucket"]
    assert count == {"train.epoch": 1, "train.sync": 1,
                     "train.bucket": buckets, "train.route": buckets,
                     "train.step": len(SIZES), "train.forward": len(SIZES),
                     "train.backward": len(SIZES), "train.optim": len(SIZES)}
    assert buckets >= 2
    by_id = {s.id: s for s in spans}
    kids = _children(spans)
    for s in spans:
        if s.name == "train.step":
            assert kids[s.id] == ["train.forward", "train.backward",
                                  "train.optim"]
            assert by_id[s.parent].name == "train.bucket"
        elif s.name == "train.bucket":
            assert sorted(kids[s.id]) == ["train.route"] + ["train.step"] * (
                len(kids[s.id]) - 1)
            assert by_id[s.parent].name == "train.epoch"
        elif s.name == "train.sync":
            assert by_id[s.parent].name == "train.epoch"
        elif s.name == "train.epoch":
            assert s.parent == 0
        if s.parent:  # a child lies inside its parent
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def _simclr_step(mb, on):
    tr = SimCLRTrainer(SimCLRConfig(compute_dtype=torch.float32),
                       SimCLRTrainConfig(batch_size=4, input_size=48,
                                         grad_cache_microbatch=mb),
                       device=CPU)
    model, opt = tr.init(0)
    u = draw_uniforms(torch.Generator().manual_seed(1), 4)
    images = torch.from_numpy((np.random.default_rng(2).random(
        (4, 48, 48, 3)) * 255).astype(np.uint8))
    if on:
        with prof.recording():
            loss = tr.train_step(model, opt, u, images, 1e-3)
    else:
        loss = tr.train_step(model, opt, u, images, 1e-3)
    return loss, model.state_dict(), prof.collect()


@pytest.mark.parametrize("mb", [2, None])
def test_simclr_step_spans(mb):
    loss, params, spans = _simclr_step(mb, on=False)
    assert spans == []
    loss_on, params_on, spans = _simclr_step(mb, on=True)
    assert torch.equal(loss_on, loss)
    for k, v in params.items():
        assert torch.equal(params_on[k], v), k
    by_id = {s.id: s for s in spans}
    (step,) = [s for s in spans if s.name == "simclr.step"]
    assert step.parent == 0
    assert _children(spans)[step.id] == ["simclr.embed", "simclr.loss",
                                         "simclr.backward", "simclr.optim"]
    # one augmentation a microbatch in each pass: under the no-grad
    # embedding and under the re-encode of the backward pass
    parents = Counter(by_id[s.parent].name for s in spans
                      if s.name == "simclr.augment")
    want = {"simclr.embed": 4 // mb, "simclr.backward": 4 // mb} if mb \
        else {"simclr.embed": 1}
    assert parents == want


def test_spans_lie_on_the_profilers_clock():
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as p, prof.recording():
        for _ in range(20):
            with prof.span("mm"):
                torch.mm(a, a)
    spans = prof.collect()
    ops = [e for e in p.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == len(spans) == 20
    for s, e in zip(spans, ops):
        assert s.start_ns - CLOCK_US * 1000 <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns + CLOCK_US * 1000
