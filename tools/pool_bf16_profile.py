"""K1-bf16 (``ops/attention_pool.attention_pool_fwd_bf16``) at K = 512, C = 2,
nonlinear q, N = 65529 and 262144: the device ms of one launch from a CUDA
graph of 20 launches, the ms by CUDA events around back-to-back launches
(where the wrapper's host time may show), each of its kernels' device ms by
``torch.profiler``, its share of the bytes bound and the bytes per second it
reaches, and ptxas's registers and spills for its kernels.

    python -m tools.pool_bf16_profile [CHECKOUT]    # on a CUDA card
    python -m tools.pool_bf16_profile --phases

Without ``CHECKOUT`` it times this tree. ``CHECKOUT`` is the root of another
tree (a commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists): then the two are timed in turns, each in a process of
its own that imports and builds its tree's ``tpumil_torch``: CHECKOUT, this
tree, this tree, CHECKOUT. Each turn prints one line per N: the tree, N, the
device ms of a launch by graph replay (the share of the bound and GB/s are
of it), the events ms (mean of 100 at N = 65529, 40 at 262144, after 5
warm-ups), the bound, and each kernel's device ms (mean of 20); then one
line of ptxas's lines for the K1-bf16 kernels.

``--phases`` looks inside this tree's kernel at N = 65529 (and times the
ring depths at 262144 too). It builds ``csrc/attention_pool_bf16.cu`` alone
into ``build/pool_bf16_profile/`` with ``-DK1_TRACE`` (CTAs 0-3 stamp
``%globaltimer`` at each phase of each tile) and with ``-DK1BF16_W0R=2..5``
(the depth of the W0 chunk ring), and prints: the logits' largest error
against a float64 evaluation of the same bf16 inputs, beside the plain f32
version's; the mean µs of each phase per tile over CTAs 0-3, tile 0 (the
ring's fill) left out; and the device ms of each ring depth by graph replay.
"""

import ctypes
import math
import os
import re
import subprocess
import sys

import torch

K, C, D = 512, 2, 128
SIZES = {65529: 100, 262144: 40}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published rate at 700 W


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def events_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of fn() from ``iters`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of each CUDA kernel fn launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0)
        if t:
            name = re.search(r"(\w+)[<(]", e.key.replace("(anonymous", ""))
            out[name.group(1) if name else e.key[:28]] = t / iters / 1e3
    return out


def kernel_name(symbol: str) -> str:
    """``pool_bf16_kernel<1,2>`` from a mangled kernel symbol of csrc/
    (``_ZN..._GLOBAL__N__<hash>_<n>_<file>_cu_<hash><len><name>I...E...``)."""
    tail = symbol.split("_cu_", 1)[-1][8:]
    m = re.match(r"\d+(\w+?_kernel)(I(?:L\w+?E)+E)?", tail)
    if not m:
        return symbol[:40]
    args = re.findall(r"L\w(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.utils import build

    _, _, log = build.build(verbose=True)
    regs, keep = [], False
    for line in log.splitlines():
        if "Function properties for" in line:
            keep = "bf16" in line
            name = kernel_name(line.split("for", 1)[1].strip())
        elif keep and ("registers" in line or "spill" in line):
            regs.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    tree = os.path.basename(os.path.abspath(root))
    gpu = gpu_line()
    for n, iters in SIZES.items():
        args = inputs(n)
        run = lambda: ap.attention_pool_fwd_bf16(*args, n, True)  # noqa: E731
        ms = graph_ms(run)
        ev = events_ms(run, iters)
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + 4 * (C * K + 2 * C + n * C)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        per = kernel_ms(run)
        print(f"{tree} N={n}: {ms:.4f} ms by graph ({ev:.4f} by events), "
              f"bound {bound:.4f} ms (bytes) = {bound / ms:.1%}, "
              f"{nbytes / ms / 1e6:.0f} GB/s; kernels "
              + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
              + f"; {gpu}", flush=True)
        del args
        torch.cuda.empty_cache()
    print(f"{tree} ptxas: " + ("; ".join(regs) or "cached build, no lines"),
          flush=True)


def variant_lib(tag: str, defines) -> ctypes.CDLL:
    """This tree's K1-bf16 source alone, built with ``-D`` ``defines``."""
    from tpumil_torch.utils import build

    out = build.BUILD_DIR.parent / "pool_bf16_profile"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"k1bf16_{tag}.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    *[f"-D{d}" for d in defines], "-shared", "-o", str(so),
                    str(build.CSRC_DIR / "attention_pool_bf16.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpumil_attention_pool_fwd_bf16_scratch.argtypes = [i] * 6
    lib.tpumil_attention_pool_fwd_bf16_scratch.restype = ctypes.c_longlong
    lib.tpumil_attention_pool_fwd_bf16.argtypes = [p] * 6 + [i] * 6 + [p] * 6
    lib.tpumil_attention_pool_fwd_bf16.restype = i
    return lib


def launcher(lib, args, n: int):
    """A call that launches ``lib``'s K1-bf16 on ``args`` (n rows, all
    valid) at the wrapper's partition, into outputs it allocates once."""
    from tpumil_torch.ops import attention_pool as ap

    rows = ap.bf16_segment_rows(args[0].device, n)
    outs = [torch.empty((C, K), device="cuda"), torch.empty(C, device="cuda"),
            torch.empty(C, device="cuda"), torch.empty((n, C), device="cuda")]
    scratch = torch.empty(
        lib.tpumil_attention_pool_fwd_bf16_scratch(1, n, n, K, C, rows),
        device="cuda")
    ptrs = [a.data_ptr() for a in args]

    def run():
        err = lib.tpumil_attention_pool_fwd_bf16(
            *ptrs, n, n, K, C, 1, rows, scratch.data_ptr(),
            *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K1-bf16 variant: CUDA error {err}")
    return run


def inputs(n: int, seed: int = 13):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def t(*shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale

    return (t(n, K, scale=1.0).to(bf), t(D, K, scale=0.05).to(bf),
            t(D, scale=0.1), t(D, D, scale=0.1).to(bf), t(D, scale=0.1),
            t(C, D, scale=0.5).to(bf))


def phases() -> None:
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from tpumil_torch.ops import attention_pool as ap

    gpu = gpu_line()
    depths = (2, 3, 4, 5)
    with ThreadPoolExecutor(len(depths) + 1) as pool:
        traced = pool.submit(variant_lib, "trace", ["K1_TRACE"])
        rings = {w: pool.submit(variant_lib, f"w0r{w}", [f"K1BF16_W0R={w}"])
                 for w in depths}
        traced, rings = traced.result(), {w: f.result()
                                          for w, f in rings.items()}
    n = 65529
    args = inputs(n)
    # the logits against float64 (f32 sums of the bf16 inputs' products)
    f, w0, b0, w2, b2, qm = (a.double() for a in args)
    ref = torch.tanh(torch.relu(f @ w0.T + b0) @ w2.T + b2) @ qm.T \
        / math.sqrt(D)
    got = ap.attention_pool_fwd_bf16(*args, n, True)[3].double()
    plain = ap.attention_pool_bf16_plain(*args, n, True)[3].double()
    scale = ref.abs().max().item()
    print(f"N={n} logits against float64, of their max: kernel "
          f"{(got - ref).abs().max().item() / scale:.3e}, plain f32 "
          f"{(plain - ref).abs().max().item() / scale:.3e}; {gpu}", flush=True)
    del f, w0, b0, w2, b2, qm, ref, got, plain
    # the phases of each tile, CTAs 0-3
    run = launcher(traced, args, n)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    stamps = np.zeros((4, 64, 8), np.uint64)
    traced.tpumil_attention_pool_bf16_trace.argtypes = [ctypes.c_void_p]
    traced.tpumil_attention_pool_bf16_trace(stamps.ctypes.data)
    rows = ap.bf16_segment_rows(args[0].device, n)
    tiles = -(-rows // ap.BF16_TILE)
    t = stamps[:, :tiles].astype(np.int64) / 1e3  # µs
    spans = {"tile period (q-MLP)": t[:, 2:, 0] - t[:, 1:-1, 0],
             "z1": t[:, 1:, 1] - t[:, 1:, 0],
             "q epilogue": t[:, 1:, 2] - t[:, 1:, 1],
             "logits": t[:, 1:, 3] - t[:, 1:, 2],
             "softmax (pool warpgroup)": t[:, 1:, 5] - t[:, 1:, 4],
             "p^T f": t[:, 1:, 6] - t[:, 1:, 5]}
    print(f"N={n} per 64-row tile, µs (mean over CTAs 0-3, tiles 1-"
          f"{tiles - 1} of {tiles}): "
          + ", ".join(f"{k} {v.mean():.2f}" for k, v in spans.items())
          + f"; CTA span {(t[:, -1, 6] - t[:, 0, 0]).mean():.2f} µs; {gpu}",
          flush=True)
    # the W0 ring's depth
    for size in SIZES:
        a = args if size == n else inputs(size)
        ms = {w: graph_ms(launcher(lib, a, size)) for w, lib in rings.items()}
        print(f"N={size} device ms by W0 ring depth: "
              + ", ".join(f"{w}: {v:.4f}" for w, v in ms.items())
              + f"; {gpu}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_bf16_profile: needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--phases":
        phases()
        return 0
    trees = [sys.argv[1], ".", ".", sys.argv[1]] if len(sys.argv) > 1 \
        else ["."]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, "-m", "tools.pool_bf16_profile",
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
