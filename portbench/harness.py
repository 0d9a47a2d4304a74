"""The benchmark's machinery, shared by every cell: the manifest and the
files a cell is made of, found by name; the card's identity and an
``nvidia-smi`` sampler beside the window; the profiler trace of a traced
window reduced to busy time, kernel times and idle gaps; the guard against
JAX in the process; and the result line.

A cell is ``BENCHMARK.json``'s workload entry plus
``portbench/workloads/<cell>.json`` (driver, traffic parameters, chips,
why) plus its configuration's file. A driver is a module
``portbench/drivers/<driver>.py`` with

  * ``setup(cell) -> state``: inputs and weights from the seed, the
    program's objects, warm-up, and any steps the correctness check
    follows (all of it counted in ``setup_s``);
  * ``window(state, seconds) -> Window``: the measured work;
  * ``observe(state) -> observed``: what the timed path produced, read
    once the window has closed and the peak memory has been read, with
    the program's state freed;
  * ``reference(state, observed, precision) -> readings`` and
    ``compare(state, observed, readings) -> [Compared]``: the plain
    reference's readings ("stated": in the configuration's precision;
    "lower": in the next precision below, the control) and the numbers
    compared, each with its limit;
  * ``as_observed(state, observed, readings) -> observed``: readings in
    the program's place, in the form the program's output is judged in;
  * ``close(state)``.

The control of a cell (``calibrate.py``) puts the reference, computed in
the lower precision, in place of ``observed`` through ``as_observed``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpumil")
BREAKDOWN_ENTRIES = 10
KERNEL_NAME_CHARS = 160
# device-side activity kinds of a profiler trace
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def checkout_root() -> Path:
    return Path(__file__).resolve().parent.parent


class BenchError(RuntimeError):
    """A run that cannot print a result (no card, a missing file, a
    forbidden module)."""


# -- the manifest and a cell's files ------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json in {root}")
    return load_json(path)


@dataclasses.dataclass
class Cell:
    """One run of one cell: its entries and files, the seed and the
    device, and a scratch directory under ``TMPDIR`` that is removed at
    the end of the run."""

    name: str
    root: Path
    entry: dict            # BENCHMARK.json's workload entry
    spec: dict             # portbench/workloads/<cell>.json
    config: dict           # the configuration's file
    seed: int
    device: Any            # a torch.device
    scratch: Path

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    def rng(self, *salt: int) -> np.random.Generator:
        """A host generator for stream ``salt`` of this seed."""
        return np.random.default_rng([self.seed, *salt])

    def seed_of(self, *salt: int) -> int:
        """A 63-bit seed for stream ``salt`` of this seed (for a
        ``torch.Generator``)."""
        return int(np.random.SeedSequence([self.seed, *salt])
                   .generate_state(2, np.uint64)[0] >> np.uint64(1))

    def generator(self, *salt: int):
        """A ``torch.Generator`` on the cell's device for stream ``salt``."""
        import torch

        return torch.Generator(device=self.device).manual_seed(
            self.seed_of(*salt))


def workload_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def load_cell(root: Path, name: str, seed: int, device,
              scratch: Path) -> Cell:
    manifest = load_manifest(root)
    entry = workload_entry(manifest, name)
    spec_path = root / "portbench" / "workloads" / f"{name}.json"
    if not spec_path.is_file():
        raise BenchError(f"no {spec_path.relative_to(root)}")
    spec = load_json(spec_path)
    if spec.get("config") != entry["config"]:
        raise BenchError(f"{spec_path.name} names configuration "
                         f"{spec.get('config')!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    config = load_json(root / config_entry(manifest,
                                           entry["config"])["file"])
    return Cell(name, root, entry, spec, config, seed, device, scratch)


def _load_module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: Path, driver: str):
    path = root / "portbench" / "drivers" / f"{driver}.py"
    if not path.is_file():
        raise BenchError(f"no driver {path.relative_to(root)}")
    return _load_module(path, f"portbench_driver_{driver}")


def metric_reader(root: Path, metric: str):
    """The reader of metric ``metric`` (per-layer, or end-to-end from the
    device's trace): its family's
    ``metrics/<family>.py``, the family being the name up to its first
    dot."""
    family = metric.split(".")[0]
    path = root / "portbench" / "metrics" / f"{family}.py"
    if not path.is_file():
        raise BenchError(f"no reader for metric {metric!r}: no "
                         f"portbench/metrics/{family}.py")
    return _load_module(path, "portbench_metric_"
                        + family.replace("-", "_"))


def peaks(root: Path) -> dict:
    return load_json(root / "portbench" / "peaks.json")


def cell_metrics(manifest: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports: those that list it, and those without a list."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


# -- what a driver hands back -------------------------------------------------

@dataclasses.dataclass
class Window:
    """The measured window: its length by the host clock (to the end of
    the last unit of work), the work attempted and failed, the cell's
    end-to-end values by metric name, and counters that per-layer readers
    take (steps, patches, requests, sizes, ...)."""

    seconds: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Compared:
    """One number compared with the plain reference, and its limit (the
    run is correct while ``value <= limit``)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


# -- the card -----------------------------------------------------------------

def nvidia_smi(query: str) -> List[List[str]]:
    """Rows of ``nvidia-smi --query-gpu=<query>`` (empty without the tool)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [[f.strip() for f in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]


def _number(text: str) -> Optional[float]:
    try:
        return float(text)
    except ValueError:
        return None


class SmiSampler:
    """``clocks.sm``, ``power.draw`` and ``temperature.gpu`` of the cards
    in use, sampled every ``period_ms`` by one ``nvidia-smi -lms`` process
    for as long as the window lasts. ``stop`` ends the process and waits
    for it. Sparse on purpose: a driver query in flight stalls the
    program's own (``cudaMemGetInfo`` of the "auto" route waited up to
    tens of ms beside a 500 ms sampler on an H100)."""

    FIELDS = ("clocks_sm_mhz", "power_draw_w", "temperature_c")

    def __init__(self, cards: int, period_ms: int = 5000):
        self.cards = cards
        self.period_ms = period_ms
        self.samples: List[Tuple[float, ...]] = []
        self._proc = None
        self._thread = None

    def start(self) -> "SmiSampler":
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi",
                 "--query-gpu=index,clocks.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader,nounits", f"-lms={self.period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None
            return self
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            f = [_number(x.strip()) for x in line.split(",")]
            if len(f) == 4 and f[0] is not None and f[0] < self.cards \
                    and None not in f[1:]:
                self.samples.append(tuple(f[1:]))

    def stop(self) -> Dict[str, Any]:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._thread.join(timeout=10)
        out: Dict[str, Any] = {"smi_samples": len(self.samples)}
        for i, key in enumerate(self.FIELDS):
            vals = [s[i] for s in self.samples]
            if vals:
                q = np.quantile(vals, [0.0, 0.5, 1.0])
                out[key] = {"min": float(q[0]), "median": float(q[1]),
                            "max": float(q[2])}
        return out


def card_identity(chips: int) -> Dict[str, Any]:
    import torch

    out: Dict[str, Any] = {"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": chips}
    rows = nvidia_smi("power.limit")
    if rows:
        out["power_limit_w"] = _number(rows[0][0])
    return out


def memory_peak_bytes(chips: int) -> int:
    import torch

    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips))


# -- the trace of a window ----------------------------------------------------

def _is_annotation(event) -> bool:
    """A range the program or the harness marked, mirrored on the device's
    timeline: no device work of its own."""
    if hasattr(event, "is_user_annotation"):
        return bool(event.is_user_annotation())
    return getattr(event, "activity_type", lambda: "")() \
        == "gpu_user_annotation"


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


@dataclasses.dataclass
class Trace:
    """Device and host activity of a traced window, in microseconds on
    the profiler's clock: device events ``(name, start, end, kind,
    device)`` and the host events of the thread that drives the device
    ``(name, start, end, kind)``. The window is traced with the CUDA
    activity alone (kernels, copies, memsets and the CUDA runtime calls):
    recording every host operator as well doubled a host-bound bag step
    on an H100, where the device's activity alone added a quarter."""

    device: List[Tuple[str, float, float, str, int]]
    host: List[Tuple[str, float, float, str]]
    window_s: float
    devices: int

    @classmethod
    def from_profiler(cls, prof, window_s: float, devices: int) -> "Trace":
        dev, host_by_tid = [], {}
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if not _is_annotation(e):
                    dev.append((name, start, end, _device_kind(name),
                                int(e.device_index())))
            else:
                kind = "cuda_runtime" if name.startswith("cuda") else "host"
                host_by_tid.setdefault(e.start_thread_id(), []).append(
                    (name, start, end, kind))
        # the driving thread: the one that called the CUDA runtime most
        host = max(host_by_tid.values(), default=[],
                   key=lambda evs: sum(ev[3] == "cuda_runtime" for ev in evs))
        return cls(sorted(dev, key=lambda e: e[1]),
                   sorted(host, key=lambda e: (e[1], -e[2])),
                   window_s, devices)

    def busy_intervals(self, device: Optional[int] = None
                       ) -> List[Tuple[float, float]]:
        """The union of device activity as disjoint sorted intervals."""
        out: List[List[float]] = []
        for _, s, t, _, d in self.device:
            if device is not None and d != device:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on a device, averaged over
        the devices in use."""
        ids = sorted({e[4] for e in self.device}) or [0]
        total = sum(t - s for d in ids
                    for s, t in self.busy_intervals(d))
        return total / 1e6 / max(self.devices, 1)

    def time_by_name(self, kinds: Sequence[str] = DEVICE_KINDS
                     ) -> Dict[str, float]:
        """Summed device seconds by operation name."""
        out: Dict[str, float] = {}
        for name, s, t, kind, _ in self.device:
            if kind in kinds:
                out[name] = out.get(name, 0.0) + (t - s) / 1e6
        return out

    def seconds_matching(self, keys: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one
        of ``keys``."""
        secs, n = 0.0, 0
        for name, s, t, kind, _ in self.device:
            if kind == "kernel" and any(k in name for k in keys):
                secs += (t - s) / 1e6
                n += 1
        return secs, n

    def kernel_launches(self) -> int:
        return sum(1 for e in self.device if e[3] == "kernel")

    def idle_gaps(self, min_us: float = 2.0) -> Dict[str, float]:
        """Idle seconds between device operations (device 0's), summed by
        what the driving thread was doing at each gap's middle: inside a
        CUDA runtime call ("in <call>"), or running host code since its
        last one ("host code after <call>")."""
        busy = self.busy_intervals(self.device[0][4] if self.device else 0)
        gaps = [(t0, s1) for (_, t0), (s1, _) in zip(busy, busy[1:])
                if s1 - t0 >= min_us]
        calls = [e for e in self.host if e[3] == "cuda_runtime"]
        out: Dict[str, float] = {}
        i = 0
        last = None
        for g0, g1 in gaps:  # gaps and calls are in time order
            mid = 0.5 * (g0 + g1)
            while i < len(calls) and calls[i][1] <= mid:
                last = calls[i]
                i += 1
            if last is None:
                label = "host code before any CUDA call"
            elif last[2] >= mid:
                label = f"in {last[0]}"
            else:
                label = f"host code after {last[0]}"
            out[label] = out.get(label, 0.0) + (g1 - g0) / 1e6
        return out

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        def top(d: Dict[str, float]) -> List[List[Any]]:
            items = sorted(d.items(), key=lambda kv: -kv[1])
            return [[k[:KERNEL_NAME_CHARS], v]
                    for k, v in items[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(self.time_by_name()),
                "idle_gaps": top(self.idle_gaps())}


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader reads: the cell, the traced window and the
    driver's counters of it, and the table of peaks."""

    cell: Cell
    trace: Trace
    window: Window
    peaks: dict


# -- the guard and the scratch directory --------------------------------------

def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process
    must not hold, compared whole (``tpumil_torch`` is not ``tpumil``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def make_scratch(cell_name: str) -> Path:
    """A scratch directory under ``TMPDIR`` for this run's files."""
    return Path(tempfile.mkdtemp(prefix=f"portbench-{cell_name}-"))


def remove_scratch(path: Path) -> None:
    shutil.rmtree(path, ignore_errors=True)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own CUDA build already lands in ``build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def now() -> float:
    return time.perf_counter()
