"""The operations and bytes the per-layer readers count, against hand
counts and PyTorch's FLOP counter at small shapes, and the trace
reductions against a hand-made trace."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO
from portbench import harness
from portbench.reference import dsmil as ref_dsmil
from portbench.reference import resnet as ref_resnet

PEAKS = harness.peaks(REPO)


def _load(name):
    return harness.metric_reader(REPO, name)


def test_peaks_table():
    assert PEAKS["flops_per_s"]["float32"] == 165e12
    assert PEAKS["flops_per_s"]["bfloat16"] == 989e12
    assert PEAKS["bytes_per_s"] == 3.35e12


def test_dsmil_step_flops_by_hand():
    mfu = _load("mfu_pct.train")
    n, k, c, d = 10, 6, 2, 4
    fwd = n * (2 * k * c + 2 * k * d + 2 * d * d + 2 * c * d + 2 * c * k)
    bwd = n * (2 * k * c + 2 * k * d + 4 * d * d + 4 * c * d + 2 * c * k)
    assert mfu.dsmil_step_flops(n, k, c, d) == fwd + bwd + 6 * c * c * k
    # K 512, C 2, D 128: 168448 forward and 201728 backward an instance
    assert mfu.dsmil_instance_flops(512, 2, 128) == 168448 + 201728


def test_dsmil_forward_flops_against_the_counter():
    mfu = _load("mfu_pct.train")
    n, k, c, d = 64, 16, 2, 8
    p = ref_dsmil.make_params(k, c, d, torch.Generator().manual_seed(0),
                              "cpu")
    f = torch.rand(n, k)
    with FlopCounterMode(display=False) as fc:
        ref_dsmil.loss(p, f, torch.tensor([1.0, 0.0]))
    # the counter sees the products: the forward's matmuls and the head
    fwd = n * (2 * k * c + 2 * k * d + 2 * d * d + 2 * c * d + 2 * c * k) \
        + 2 * c * c * k
    assert fc.get_total_flops() == fwd
    assert mfu.dsmil_step_flops(n, k, c, d) > 2 * fwd


@pytest.mark.parametrize("size", [32, 64, 224])
def test_resnet18_flops_against_the_counter(size):
    mfu = _load("mfu_pct.extract")
    w = ref_resnet.make_weights(torch.Generator().manual_seed(0), "cpu")
    x = torch.rand(1, size, size, 3)
    with FlopCounterMode(display=False) as fc:
        ref_resnet.forward(w, x)
    assert fc.get_total_flops() == mfu.resnet18_forward_flops(size)
    assert len(mfu.resnet18_convs(size)) == 20


def test_simclr_view_flops():
    mfu = _load("mfu_pct.simclr")
    # 3 x the forward, less the stem's input gradient: 10.648 GFLOP
    assert mfu.simclr_view_flops(224) == pytest.approx(10.6477e9, rel=1e-4)
    w = {k: v.requires_grad_() for k, v in ref_resnet.make_weights(
        torch.Generator().manual_seed(0), "cpu").items()}
    x = torch.rand(1, 32, 32, 3)
    with FlopCounterMode(display=False) as fc:
        ref_resnet.forward(w, x).sum().backward()
    assert fc.get_total_flops() == pytest.approx(
        mfu.simclr_view_flops(32) - 3 * 2.0 * (512 * 512 + 512 * 256))


def test_stem_and_in_bounds_by_hand():
    stem = _load("stem_roofline_pct.extract")
    inr = _load("in_roofline_pct.extract")
    b = 128
    flops = 2 * b * 112 * 112 * 64 * 147
    assert stem.stem_flops(b) == flops
    # f32 at 3xTF32: 0.183 ms a launch of 128, bound by operations
    assert stem.stem_bound_s(b, "float32", PEAKS) == pytest.approx(
        flops / 165e12)
    assert stem.stem_bound_s(b, "float32", PEAKS) * 1e3 == pytest.approx(
        0.1835, abs=1e-3)
    elems = 4 * 56 * 56 * 64 + 5 * 28 * 28 * 128 + 5 * 14 * 14 * 256 \
        + 5 * 7 * 7 * 512
    assert inr.forward_bytes(b, "float32") == 2 * 4 * b * elems
    # 0.514 ms over the 19 sites of one forward of 128 in f32
    assert inr.forward_bytes(b, "float32") / 3.35e12 * 1e3 == \
        pytest.approx(0.514, abs=1e-3)


def _trace():
    dev = [("k1", 0.0, 10.0, "kernel", 0),
           ("k2", 5.0, 20.0, "kernel", 0),
           ("Memcpy HtoD", 30.0, 40.0, "gpu_memcpy", 0),
           ("k1", 100.0, 110.0, "kernel", 0)]
    host = [("cudaLaunchKernel", 0.0, 1.0, "cuda_runtime"),
            ("cudaMemcpyAsync", 26.0, 35.0, "cuda_runtime"),
            ("cudaStreamSynchronize", 45.0, 105.0, "cuda_runtime")]
    return harness.Trace(dev, host, window_s=200e-6, devices=1)


def test_trace_reductions():
    tr = _trace()
    assert tr.busy_intervals() == [(0.0, 20.0), (30.0, 40.0), (100.0, 110.0)]
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.kernel_launches() == 3
    assert tr.seconds_matching(("k1",)) == (pytest.approx(20e-6), 2)
    gaps = tr.idle_gaps()
    assert gaps == {"host code after cudaLaunchKernel": pytest.approx(10e-6),
                    "in cudaStreamSynchronize": pytest.approx(60e-6)}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert len(bd["idle_gaps"]) == 2


def test_readers_on_a_trace():
    tr = _trace()
    win = harness.Window(seconds=200e-6, attempted=2, failed=0,
                         end_to_end={}, counters={"steps": 2})
    ctx = harness.ReadContext(SimpleNamespace(), tr, win, PEAKS)
    assert _load("device_idle_pct.train").read(ctx, "x") == \
        pytest.approx(80.0)
    assert _load("launches_per_step.train").read(ctx, "x") == 1.5
    assert _load("bag_step_device_ms").read(ctx, "x") == pytest.approx(0.02)
    assert _load("step_wall_ms.train").read(ctx, "x") == pytest.approx(0.1)
    # nothing to read: no value, never a 0
    assert _load("stem_roofline_pct.extract").read(ctx, "x") is None
    assert _load("mfu_pct.train").read(ctx, "x") is None
    assert _load("batch_fill_pct.serve").read(ctx, "x") is None
    empty = harness.ReadContext(SimpleNamespace(),
                                harness.Trace([], [], 200e-6, 1), win, PEAKS)
    assert _load("bag_step_device_ms").read(empty, "x") is None
    win.counters.update(batches=4, patches=256, batch_size=128)
    assert _load("batch_fill_pct.serve").read(ctx, "x") == 50.0
    assert math.isclose(_load("copy_share_pct.simclr").read(ctx, "x"), 0.0)
