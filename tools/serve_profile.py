"""Where the time goes on the card: the embedder forward and the served
embed path of ``tpumil_torch``, broken down by device kernel.

    python -m tools.serve_profile                # on a CUDA card
    python -m tools.serve_profile --device cpu --batch_size 4 \\
        --patch_size 32 --patches 8              # a quick CPU dry run

Phases (each prints its own lines):
  1. forward -- ResNet18-IN at ``--batch_size`` x ``--patch_size``^2, f32 and
                bf16: ``torch.profiler`` over 5 forwards after 3 warm-ups;
                device time per forward and each kernel class's share of it.
  2. serve   -- ``tpumil_torch.cli.serve`` (f32) on 127.0.0.1 with 4
                concurrent clients of ``--patches`` patches each on
                /v1/embed, traced as a whole: wall time, patches/s, the
                device's busy share of the wall (union of kernel and copy
                intervals), the batcher's forward time on the host clock,
                the kernel-class shares and the client's request encoding.
  3. copy    -- one uint8 batch to the card from pageable and from pinned
                host memory (CUDA events).

Device numbers come from the profiler's chrome trace (events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``). When that trace holds no
device event (as on the CPU), the device lines say "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 5     # profiled forwards per precision
CLIENTS = 4   # concurrent /v1/embed clients
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel class -> substrings of the (lower-cased) kernel name, tried in order
CLASSES = (
    ("stem kernel (K5)", ("stem_conv_kernel", "stem_norm_pool_kernel")),
    ("IN kernel", ("instance_norm_kernel",)),
    ("maxpool", ("max_pool",)),
    ("layout transpose", ("nhwctonchw", "nchwtonhwc")),
    ("conv/gemm", ("conv", "xmma", "gemm", "cudnn", "implicit", "cutlass",
                   "winograd", "fft")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.strip().splitlines()[0]


def classify(event: Dict) -> str:
    if event["cat"] != "kernel":
        return "copy/memset"
    name = event["name"].lower()
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def device_events(prof) -> List[Dict]:
    """The trace's device events (kernels, copies, memsets)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def shares(events: List[Dict]) -> Tuple[float, Dict[str, float]]:
    """(summed device time in us, {class: share of it})."""
    by_class: Dict[str, float] = defaultdict(float)
    for e in events:
        by_class[classify(e)] += float(e["dur"])
    total = sum(by_class.values())
    return total, {k: v / total for k, v in
                   sorted(by_class.items(), key=lambda kv: -kv[1])}


def busy_us(events: List[Dict]) -> float:
    """Length of the union of the events' intervals, in us."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    total, cur_start, cur_end = 0.0, None, None
    for s, t in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def fmt_shares(share: Dict[str, float]) -> str:
    return ", ".join(f"{k} {v * 100:.1f}%" for k, v in share.items())


def activities(dev: torch.device):
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_forward(dev: torch.device, args, gpu: str) -> None:
    from tpumil_torch.models import embedder

    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(
        0, 256, (args.batch_size, args.patch_size, args.patch_size, 3),
        np.uint8)).to(dev)
    for precision in ("f32", "bf16"):
        cfg = embedder.EmbedderConfig(backbone="resnet18", norm="instance",
                                      precision=precision)
        model = embedder.init_params(0, cfg, dev)
        with torch.inference_mode():
            for _ in range(3):
                model(imgs)
            sync(dev)
            with profile(activities=activities(dev)) as prof:
                for _ in range(ITERS):
                    model(imgs)
                sync(dev)
        events = device_events(prof)
        if not events:
            log(f"[forward] {precision}: device time not measured (no device "
                f"events in the trace)")
            continue
        total, share = shares(events)
        log(f"[forward] resnet18-IN {precision} {args.patch_size}^2 "
            f"B={args.batch_size}: device {total / ITERS / 1e3:.3f} "
            f"ms/forward over {ITERS} forwards; {fmt_shares(share)}; {gpu}")
        del model


def phase_serve(dev: torch.device, args, gpu: str) -> None:
    from tpumil_torch.cli import serve
    from tpumil_torch.infer.client import ServingClient
    from tpumil_torch.models import embedder

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (args.patches, args.patch_size,
                                 args.patch_size, 3), np.uint8)
    t0 = time.perf_counter()
    body = ServingClient._npy(imgs)
    encode_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "embedder.pth")
        cfg = embedder.EmbedderConfig(backbone="resnet18", num_classes=2)
        src = embedder.init_params(0, cfg, torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(src), ckpt)
        service = serve.build_service(serve.parse_args([
            "--embedder_weights", ckpt,
            "--aggregator_weights",
            os.path.join(REPO, "tests", "data", "tcga_aggregator.pth"),
            "--num_classes", "2", "--device", dev.type,
            "--precision", "f32",
            "--batch_size", str(args.batch_size),
            "--patch_size", str(args.patch_size)]))
    # the batcher's forward (H2D + forward + D2H) on the host clock
    batcher = service._batcher
    inner, fwd_s = batcher._fwd, []

    def timed(buf):
        t = time.perf_counter()
        out = inner(buf)
        fwd_s.append(time.perf_counter() - t)
        return out

    batcher._fwd = timed
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        client = ServingClient(f"http://{host}:{port}", timeout=600)
        client.embed(imgs[:1])  # first request: connection set-up
        fwd_s.clear()
        errors: List[BaseException] = []

        def run():
            try:
                feats = client.embed(imgs)
                if feats.shape != (args.patches, 512):
                    raise AssertionError(f"bad features {feats.shape}")
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=run) for _ in range(CLIENTS)]
        with profile(activities=activities(dev)) as prof:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            sync(dev)
        if errors:
            raise RuntimeError(f"embed requests failed: {errors}")
        stats = client.stats()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    n = CLIENTS * args.patches
    log(f"[serve] {CLIENTS} clients x {args.patches} patches on /v1/embed "
        f"(f32, B={args.batch_size}): wall {wall:.3f} s = "
        f"{n / wall:.0f} patches/s; {stats['batches']} batches, mean fill "
        f"{stats['mean_batch_fill']}; {gpu}")
    log(f"[serve] batcher forward (H2D + forward + D2H, host clock): "
        f"{sum(fwd_s):.3f} s in all, {np.mean(fwd_s) * 1e3:.1f} ms per batch "
        f"over {len(fwd_s)} batches; the rest of the wall the worker waits "
        f"for rows")
    log(f"[serve] client request encoding (np.save of {len(body) / 1e6:.1f} "
        f"MB): {encode_ms:.1f} ms per request")
    events = device_events(prof)
    if not events:
        log("[serve] device busy share: not measured (no device events in "
            "the trace)")
        return
    busy = busy_us(events) / 1e6
    total, share = shares(events)
    log(f"[serve] device busy {busy:.3f} s = {busy / wall * 100:.1f}% of the "
        f"wall (idle {100 - busy / wall * 100:.1f}%); device time "
        f"{total / 1e6:.3f} s: {fmt_shares(share)}; {gpu}")
    h2d = [e for e in events if e["cat"] == "gpu_memcpy"
           and "htod" in e["name"].lower()]
    if h2d:
        log(f"[serve] H2D copies: {len(h2d)}, "
            f"{np.mean([e['dur'] for e in h2d]) / 1e3:.3f} ms each "
            f"({h2d[0]['name']})")


def phase_copy(dev: torch.device, args, gpu: str) -> None:
    if dev.type != "cuda":
        log("[copy] pageable vs pinned H2D: not measured (no CUDA device)")
        return
    shape = (args.batch_size, args.patch_size, args.patch_size, 3)
    pageable = torch.zeros(shape, dtype=torch.uint8)
    pinned = torch.zeros(shape, dtype=torch.uint8).pin_memory()
    times = {}
    for name, src in (("pageable", pageable), ("pinned", pinned)):
        for _ in range(3):
            src.to(dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            src.to(dev, non_blocking=name == "pinned")
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / 10
    log(f"[copy] one {pageable.numel() / 1e6:.1f} MB uint8 batch to the card: "
        f"pageable {times['pageable']:.3f} ms, pinned {times['pinned']:.3f} "
        f"ms; {gpu}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--patch_size", type=int, default=224)
    p.add_argument("--patches", type=int, default=512)
    args = p.parse_args(argv)
    from tpumil_torch.utils.device import select_device

    dev = select_device(args.device)
    gpu = gpu_line() if dev.type == "cuda" else "cpu"
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_forward(dev, args, gpu)
    phase_serve(dev, args, gpu)
    phase_copy(dev, args, gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
