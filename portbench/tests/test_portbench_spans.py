"""The program's spans over a traced window (``portbench/spans.py``) and the
readers of the metrics that read them, against hand-made traces; the
correlation ids taken from a profiler's events; and a window of the cells
on the CPU at small sizes with the recorder on and off."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from conftest import REPO
from portbench import harness, spans

CPU = torch.device("cpu")
PEAKS = harness.peaks(REPO)


def _read(name, tr, steps=2):
    win = harness.Window(seconds=1e-3, attempted=steps, failed=0,
                         end_to_end={}, counters={"steps": steps})
    ctx = harness.ReadContext(SimpleNamespace(), tr, win, PEAKS)
    return harness.metric_reader(REPO, name).read(ctx, name)


def _span(name, sid, parent, start, end, tid=7):
    return (name, sid, parent, tid, float(start), float(end))


def _train_trace():
    """Two bag steps in a bucket; a launch after them in the bucket, one
    outside every span and a device event whose launch is not traced; a
    span of another thread over the outside launch."""
    sp = [_span("train.bucket", 1, 0, 0, 400),
          _span("train.route", 2, 1, 0, 5),
          _span("train.step", 3, 1, 10, 100),
          _span("train.forward", 4, 3, 10, 40),
          _span("train.backward", 5, 3, 40, 70),
          _span("train.optim", 6, 3, 70, 95),
          _span("train.step", 7, 1, 200, 300),
          _span("train.forward", 8, 7, 200, 240),
          _span("train.backward", 9, 7, 240, 270),
          _span("train.optim", 10, 7, 270, 295),
          _span("loader", 11, 0, 490, 520, tid=8)]
    launches = [(12, 1), (42, 2), (72, 3), (74, 4), (202, 5), (272, 6),
                (350, 7), (500, 8)]
    host = [("cudaLaunchKernel", t, t + 1.0, "cuda_runtime")
            for t, _ in launches]
    dev = [("k_f", 15, 25, 1), ("k_b", 45, 65, 2), ("adam", 75, 77, 3),
           ("adam", 78, 80, 4), ("k_f", 205, 215, 5), ("adam", 275, 277, 6),
           ("acc", 352, 353, 7), ("k_x", 505, 510, 8), ("lost", 600, 601, 99)]
    return spans.SpanTrace(
        [(n, float(s), float(t), "kernel", 0) for n, s, t, _ in dev], host,
        window_s=1e-3, devices=1, spans=sp,
        device_corr=[c for *_, c in dev], host_corr=[c for _, c in launches])


def test_innermost_span_at_each_time():
    sp = sorted(_train_trace().spans[:-1], key=lambda s: (s[4], -s[5]))
    names = [None if j is None else sp[j][0] for j in spans.innermost(
        sp, [95.0, 70.0, -1.0, 3.0, 69.9, 150.0, 400.0, 12.0])]
    assert names == ["train.step", "train.optim", None, "train.route",
                     "train.backward", "train.bucket", None, "train.forward"]


def test_launches_put_down_to_spans():
    tr = _train_trace()
    assert tr.launch_spans() == [
        "train.forward", "train.backward", "train.optim", "train.optim",
        "train.forward", "train.optim", "train.bucket", spans.OUTSIDE,
        spans.NO_LAUNCH]
    assert tr.device_seconds_inside("train.optim") == pytest.approx(6e-6)
    assert tr.device_seconds_inside("train.step") == pytest.approx(46e-6)
    by = tr.device_seconds_by_span()
    assert by["train.forward"] == pytest.approx(20e-6)
    assert by[spans.OUTSIDE] == pytest.approx(5e-6)
    cov = spans.coverage(tr)
    assert cov["kernel_launches"] == 9 and cov["paired_with_launch"] == 8
    assert cov["launches_in_leaf_pct"] == pytest.approx(100 * 6 / 9)
    assert cov["device_attributed_pct"] == pytest.approx(100 * 47 / 53)
    assert [k for k, _ in cov["left_over"]] == [
        f"{spans.OUTSIDE}: k_x", f"{spans.NO_LAUNCH}: lost"]


def test_idle_gaps_put_down_to_spans():
    tr = _train_trace()
    want = {"train.forward": 20e-6, "train.optim": 10e-6,
            "train.bucket": 200e-6, "train.backward": 60e-6,
            spans.OUTSIDE: 242e-6}
    got = tr.idle_spans()
    assert got == pytest.approx(want)
    # the same gaps as idle_gaps, put down another way
    assert sum(got.values()) == pytest.approx(sum(tr.idle_gaps().values()))
    bd = tr.breakdown()
    assert list(bd) == ["device_ops", "idle_gaps", "idle_spans"]
    assert bd["idle_spans"][0] == [spans.OUTSIDE, pytest.approx(242e-6)]
    # without spans, or without device events, the breakdown is unchanged
    for empty in (spans.SpanTrace(tr.device, tr.host, 1e-3, 1),
                  spans.SpanTrace([], tr.host, 1e-3, 1, spans=tr.spans)):
        assert list(empty.breakdown()) == ["device_ops", "idle_gaps"]


def test_train_readers():
    tr = _train_trace()
    assert _read("host_ms_per_step.train", tr) == pytest.approx(0.095)
    # Adam's 6 µs of device time over the 2 steps
    assert _read("optim_device_ms_per_step.train", tr) == \
        pytest.approx(0.003)
    assert _read("augment_device_pct.simclr", tr) is None


def test_augment_reader():
    sp = [_span("simclr.step", 1, 0, 0, 100),
          _span("simclr.embed", 2, 1, 0, 40),
          _span("simclr.augment", 3, 2, 0, 10),
          _span("simclr.backward", 4, 1, 50, 90),
          _span("simclr.augment", 5, 4, 50, 60)]
    host = [("cudaLaunchKernel", t, t + 1.0, "cuda_runtime")
            for t in (2, 20, 52, 70)]
    dev = [("aug", 3, 8, "kernel", 0), ("conv", 21, 36, "kernel", 0),
           ("aug", 53, 58, "kernel", 0), ("dgrad", 71, 96, "kernel", 0)]
    tr = spans.SpanTrace(dev, host, 1e-3, 1, spans=sp,
                         device_corr=[1, 2, 3, 4], host_corr=[1, 2, 3, 4])
    assert _read("augment_device_pct.simclr", tr) == pytest.approx(20.0)
    assert _read("host_ms_per_step.simclr", tr) == pytest.approx(0.1)


def test_readers_find_nothing_in_a_plain_trace():
    """A program that records no spans, and the harness's Trace, which
    carries none: no value, never a 0, and nothing raised."""
    dev = [("k", 0.0, 10.0, "kernel", 0)]
    host = [("cudaLaunchKernel", 0.0, 1.0, "cuda_runtime")]
    for tr in (harness.Trace(dev, host, 1e-3, 1),
               spans.SpanTrace(dev, host, 1e-3, 1),
               spans.SpanTrace(dev, host, 1e-3, 1,
                               spans=[_span("train.step", 1, 0, 0, 5)])):
        for name in ("optim_device_ms_per_step.train",
                     "augment_device_pct.simclr"):
            assert _read(name, tr) is None
    assert _read("host_ms_per_step.train", harness.Trace(dev, host, 1e-3,
                                                         1)) is None


class _Event:
    def __init__(self, name, start, dur, cuda, corr, annotation=False):
        self._v = (name, start, dur, cuda, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def device_index(self):
        return 0

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_correlation_ids_from_the_profilers_events():
    events = [_Event("k2", 9000, 1000, True, 22),
              _Event("cudaLaunchKernel", 5000, 500, False, 22),
              _Event("k1", 3000, 1000, True, 11),
              _Event("range", 0, 9000, True, 0, annotation=True),
              _Event("cudaLaunchKernel", 1000, 500, False, 11),
              _Event("Activity Buffer Request", 1000, 9000, False, 11)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    from tpumil_torch.utils.prof import Span

    tr = spans.SpanTrace.from_profiler(
        prof, 1e-3, 1, [Span("train.forward", 1, 0, 7, 500, 6000)])
    assert [d[0] for d in tr.device] == ["k1", "k2"]
    assert tr.device_corr == [11, 22]
    assert [h[0] for h in tr.host] == ["Activity Buffer Request",
                                       "cudaLaunchKernel",
                                       "cudaLaunchKernel"]
    assert tr.host_corr == [11, 11, 22]
    assert tr.spans == [("train.forward", 1, 0, 7, 0.5, 6.0)]
    # the launch is the call named cu*, not the buffer request
    assert tr.launch_starts() == [1.0, 5.0]
    assert tr.launch_spans() == ["train.forward", "train.forward"]
    plain = harness.Trace.from_profiler(prof, 1e-3, 1)
    assert (plain.device, plain.host) == (tr.device, tr.host)


@pytest.mark.parametrize("cell", ["tcga-train", "simclr-b4096"])
def test_a_window_on_the_cpu(small_checkout, cell):
    got = {on: spans.measure(small_checkout, cell, 2 ** 31 + 5, 0.2, on, CPU)
           for on in (True, False)}
    step = {"tcga-train": "train.step", "simclr-b4096": "simclr.step"}[cell]
    assert got[True]["span_counts"][step] >= 1
    assert got[False]["span_counts"] == {}
    if cell == "tcga-train":
        assert got[True]["metrics"]["host_ms_per_step.train"] > 0
        assert got[False]["metrics"]["host_ms_per_step.train"] is None
        assert got[True]["metrics"]["optim_device_ms_per_step.train"] is None
    for res in got.values():  # no device events on the CPU
        assert list(res["breakdown"]) == ["device_ops", "idle_gaps"]
        assert res["span_cost_ns"]["on"] > res["span_cost_ns"]["off"]
