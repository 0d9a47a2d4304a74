"""Driver ``serve_embed``: the port's HTTP server, ``cli/serve.py``'s
``make_server(build_service(...))``, under an open loop of ``/v1/embed``
requests.

Set-up makes the embedder's weights on the device from the seed and saves
them as an embedder checkpoint in the run's scratch directory, builds the
service from ``cli/serve.py``'s own arguments (batch, wait, precision from
the configuration) and serves it on 127.0.0.1 at a free port from a thread.
It makes a pool of tissue-like patches on the device, copies it to shared
memory, and starts the load generator (``traffic/loadgen.py``) in a child
process, which warms the HTTP path with a few requests of the largest
size. The window: the child sends the schedule of ``traffic/arrivals.py``
(Poisson arrivals at the cell's rate, log-uniform sizes) and waits for
every answer; ``serve_p95_ms`` is the 95th percentile over every request
due in the window of the time from when it was due to when its answer was
read, a failed request counting as answered at the client's timeout.

The check, once the window has closed: the answers of requests drawn from
the seed, the largest among them, against the plain reference's features
(``reference/resnet.py``) of the same patches.

Its cell, ``tcga-serve``, is held out of ``BENCHMARK.json`` until its tail
can be bounded (PERF.md, Open questions); the driver serves it as it
stands, and the CPU tests run it through the held entries.
"""

from __future__ import annotations

import collections
import dataclasses
import multiprocessing as mp
import threading
from multiprocessing import shared_memory
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.reference import resnet as ref
from portbench.traffic import arrivals
from portbench.traffic import images as traffic_images
from portbench.traffic import loadgen

WARM_REQUESTS = 4


@dataclasses.dataclass
class State:
    cell: harness.Cell
    service: Any
    server: Any
    thread: threading.Thread
    shm: Any
    pool: np.ndarray
    weights: Dict[str, torch.Tensor]
    result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    keep: List[int] = dataclasses.field(default_factory=list)
    offsets: Any = None
    sizes: Any = None
    proc: Any = None
    jobs: Any = None
    results: Any = None


def _serve_args(cell: harness.Cell, weights_path: str):
    from tpumil_torch.cli import serve

    emb = cell.config["embedder"]
    srv = cell.spec["server"]
    return serve.parse_args([
        "--embedder_weights", weights_path, "--device", cell.device.type,
        "--num_classes", str(cell.config["aggregator"]["num_classes"]),
        "--backbone", emb["backbone"], "--norm", emb["norm"],
        "--precision", emb["precision"],
        "--batch_size", str(srv["batch_size"]),
        "--patch_size", str(emb["patch_size"]),
        "--max_wait_ms", str(srv["max_wait_ms"]), "--port", "0"])


def _start_loadgen(state: "State") -> None:
    ctx = mp.get_context("spawn")
    state.jobs, state.results = ctx.Queue(), ctx.Queue()
    state.proc = ctx.Process(target=loadgen.run, args=(
        state.server.server_address[1], state.shm.name, state.pool.shape,
        int(state.cell.spec["server"]["client_threads"]), state.jobs,
        state.results))
    state.proc.start()


def _exchange(state: "State", due, sizes, offsets, keep) -> Dict[str, Any]:
    """Run one schedule through the load generator; returns its results."""
    state.jobs.put((np.asarray(due), np.asarray(sizes), np.asarray(offsets),
                    list(keep)))
    return state.results.get(timeout=len(due) * loadgen.TIMEOUT_S + 600)


def _stop_loadgen(state: "State") -> None:
    if state.proc is not None:
        state.jobs.put(None)
        state.proc.join(timeout=60)
        if state.proc.is_alive():
            state.proc.kill()
            state.proc.join()
        state.proc = None


def setup(cell: harness.Cell) -> State:
    from tpumil_torch.cli import serve

    tp = cell.traffic
    weights = ref.make_weights(cell.generator(1), cell.device)
    path = str(cell.scratch / "embedder.pth")
    # the reference's embedder export: every convolution, torchvision order
    torch.save(collections.OrderedDict(
        (n, weights[n].cpu()) for n, _, _ in ref.conv_shapes()), path)
    service = serve.build_service(_serve_args(cell, path))
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    imgs = traffic_images.tissue(int(tp["pool"]), int(tp["size"]),
                                 cell.generator(2), cell.device).cpu().numpy()
    shm = shared_memory.SharedMemory(create=True, size=imgs.nbytes)
    pool = np.ndarray(imgs.shape, np.uint8, buffer=shm.buf)
    pool[:] = imgs
    state = State(cell, service, server, thread, shm, pool, weights)
    _start_loadgen(state)
    big = int(tp["max_patches"])
    _exchange(state, np.zeros(WARM_REQUESTS), np.full(WARM_REQUESTS, big),
              np.zeros(WARM_REQUESTS, np.int64), [])
    return state


def window(state: State, seconds: float) -> harness.Window:
    tp = state.cell.traffic
    rng = state.cell.rng(3)
    due, sizes = arrivals.schedule(tp, seconds, rng)
    n_pool = state.pool.shape[0]
    offsets = rng.integers(0, n_pool - sizes + 1)
    n_keep = min(int(state.cell.spec["check_requests"]), len(sizes))
    keep = {int(np.argmax(sizes))}
    keep.update(int(i) for i in rng.choice(len(sizes), n_keep,
                                           replace=False))
    before = state.service.stats()
    t0 = harness.now()
    out = _exchange(state, due, sizes, offsets, sorted(keep))
    elapsed = harness.now() - t0
    after = state.service.stats()
    # a request that failed or timed out counts as answered at the
    # client's timeout: later than any latency limit
    lat = np.array([loadgen.TIMEOUT_S if x is None else x
                    for x in out["latency_s"]])
    failed = sum(x is None for x in out["latency_s"])
    state.result, state.keep = out, sorted(keep)
    state.offsets, state.sizes = offsets, sizes
    d = {k: after[k] - before[k] for k in ("requests", "patches", "batches",
                                            "errors")}
    return harness.Window(
        seconds=elapsed, attempted=len(sizes), failed=failed,
        end_to_end={"serve_p95_ms": float(np.quantile(lat, 0.95)) * 1e3},
        counters={"requests": d["requests"], "patches": d["patches"],
                  "batches": d["batches"], "errors": d["errors"],
                  "batch_size": int(state.cell.spec["server"]["batch_size"]),
                  "served_patches_per_s": float(np.sum(sizes[[
                      x is not None for x in out["latency_s"]]])) / elapsed,
                  "p50_ms": float(np.quantile(lat, 0.5)) * 1e3,
                  "late_p95_ms": float(np.quantile(out["late_s"], 0.95))
                  * 1e3})


def _stop(state: State) -> None:
    _stop_loadgen(state)
    if state.server is not None:
        state.server.shutdown()
        state.server.server_close()
        state.thread.join(timeout=30)
        state.service.close()
        state.server = state.service = None


def observe(state: State) -> Dict[str, Any]:
    """The sampled requests' answers (None for one never answered);
    stops the server and frees the service."""
    _stop(state)
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    answers = state.result.get("answers", {})
    return {"requests": [(i, int(state.offsets[i]), int(state.sizes[i]),
                          answers.get(i)) for i in state.keep]}


def reference(state: State, observed, precision: str) -> Dict[str, Any]:
    """The reference's features of the sampled requests' patches, in f32
    ("stated") or with TF32 allowed ("lower", the control)."""
    tf32 = precision == "lower"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        feats = []
        for _, off, n, _ in observed["requests"]:
            imgs = torch.from_numpy(state.pool[off:off + n].copy()).to(
                state.cell.device)
            feats.append(ref.features(state.weights, imgs).double().cpu()
                         .numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {"feats": feats}


def compare(state: State, observed, readings) -> List[harness.Compared]:
    limits = state.cell.spec["limits"]
    gap, missing = 0.0, 0
    for (_, _, _, got), want in zip(observed["requests"], readings["feats"]):
        if got is None or got.shape != want.shape:
            missing += 1
            continue
        gap = max(gap, float(np.max(np.abs(got.astype(np.float64) - want))))
    return [harness.Compared("feat_gap", gap, limits["feat_gap"]),
            harness.Compared("sampled_unanswered", float(missing), 0.0)]


def as_observed(state: State, observed, readings) -> Dict[str, Any]:
    """Reference features in the program's place, as f32 answers."""
    return {"requests": [(i, off, n, f.astype(np.float32)) for
                         (i, off, n, _), f in zip(observed["requests"],
                                                  readings["feats"])]}


def close(state: State) -> None:
    _stop(state)
    state.pool = None
    state.shm.close()
    state.shm.unlink()
    state.weights = {}
