"""Drive the PyTorch port's serving, training (WSI and classic MIL),
feature-extraction, slide-streaming, inference-and-heatmap and SimCLR
pretraining paths, the bf16 giant-bag forward, the five-stage pipeline and
both halves of scale-out (at world 1) once on one CUDA card (sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device    -- nvidia-smi name/power limit, torch/CUDA versions; needs a
                  CUDA card of capability (9, 0)
  2. build     -- compile tpumil_torch/csrc/*.cu into build/tpumil_torch/
  3. depthwise -- TransMIL's depthwise convs (csrc/depthwise.cu) at the
                  cohort's mean and largest bags (N = 6758 and 65536: P =
                  65792, side 256): residual_conv and ppeg against their
                  plain versions on the same card inputs, output and every
                  gradient; the device time of the kernels, of the plain
                  versions and of F.conv2d as the reference calls it,
                  beside their bound; then one BagTrainer TransMIL step at
                  the published widths with its launches counted (6 and 4)
                  and no ATen depthwise kernel in its trace
  4. kernel    -- fused_instance_norm (K4) vs its plain PyTorch version at
                  the five ResNet18 IN shapes (B=128), f32 and bf16, relu
                  on/off, a bitwise rerun, plus a constant plane; the route
                  each shape takes (one read over a cluster, or two reads)
                  and, per shape, the device time of that route and of the
                  two-read route; the sum over one forward's 19 IN sites
  5. embedder  -- ResNet18-IN f32 224^2 batch 128: kernel route vs plain
                  route, 19 K4 launches and 1 K5 launch per forward
  6. golden    -- the shipped aggregators vs the reference's golden outputs
  7. serve     -- tpumil_torch.cli.serve on 127.0.0.1, concurrent clients on
                  /v1/embed, /v1/predict_patches, /v1/predict, /v1/heatmap
  8. pool      -- the attention-pool kernels K1, K2, K3 vs their plain
                  versions at K=512, C=2, N up to 262144 (K1's logits too);
                  bitwise reruns; CUDA-event times, K3 with dF written and
                  skipped, beside the times of their earlier FFMA designs
  9. train     -- BagTrainer at full width on seeded synthetic bags up to
                  65529 instances: the kernel route against the eager route
                  from the same init and seed; ms per bag step; each route's
                  working set per instance; then a bf16 DSMILConfig
                  (compute_dtype) from the same init and seed with
                  fused_threshold=16384: losses within rtol 2e-2 of the f32
                  eager route's and unlike them, no K1-K3 launch; one eager
                  bag step at N=4000 and 65529 in bf16 and f32 in turns
                  (host ms and torch.profiler device ms); the bf16 step's
                  working set per instance; a bf16 DeviceBagStore's nbytes
                  and one predict on it
 10. train_wsi -- python -m tpumil_torch.cli.train_wsi --device cuda on a
                  synthetic TCGA-shaped CSV dataset, 5-fold-cv
 11. train_mil -- the classic-MIL path on tests/data/musk1_mini.svm (K=166,
                  C=1, 3 folds x 2 epochs): python -m tpumil_torch.cli.train_mil
                  for dsmil, run_mil_cv for abmil/meanpool/maxpool, ms per bag
                  step; then BagTrainer's kernel route at K=166 (padded for
                  K1-K3) against its eager route, with K1-K3 launch counts
 12. stem      -- the fused stem (K5) vs its plain version at B=128 224^2,
                  f32 and bf16, blank tiles and a tile-boundary image, a
                  bitwise rerun; CUDA-event times of K5, the plain version
                  and the conv route (cuDNN conv, K4, max pool: the stem of
                  other inputs), beside the earlier FFMA design's times
 13. compute_feats -- a JPEG tree of 2 classes x 3 bags x 256 patches:
                  python -m tpumil_torch.cli.compute_feats --device cuda,
                  compute_feats in-process with the stem in K5 and, in
                  turns, in the conv route, then train_wsi on the CSVs
 14. slide_feats -- two synthetic 3-level pyramidal TIFFs at 20x (4480^2,
                  400 tiles of 224^2 each, textured tissue over ~60%):
                  python -m tpumil_torch.cli.tiler and python -m
                  tpumil_torch.cli.slide_feats --device cuda, the same tile
                  set per slide; then embed_slide_streaming in-process with
                  K5/K4 launches counted (1 and 19 per batch), its features
                  against embed_arrays of the same tiles read back, the
                  padded batch included; tiles/s, slides/min, the device's
                  busy share, the reader and the edge filter
 15. attention_map -- a folder of 3 bags of 600, 1000 and 130 JPEG patches
                  of 224^2 on tile grids with holes: python -m
                  tpumil_torch.cli.attention_map (TCGA aggregator, f32,
                  --export_scores 1 --seed 0), testing_tcga, testing_c16 and
                  attention_map --precision bf16, all --device cuda, a PNG
                  per bag each; then run_attention_maps in-process with
                  K5/K4 launches counted (1 and 19 per batch of 64), each
                  bag's BagInference against embed_paths plus the
                  aggregator and the 130-patch bag against the port's CPU
                  path; patches/s per bag, the device's busy share, the wall
                  split into decode and embed, aggregate, render, PNG, CSV
 16. simclr    -- a tree of 320 JPEG patches of 224^2: python -m
                  tpumil_torch.cli.simclr_train --device cuda (ResNet18-IN,
                  bf16, batch 64, 3 epochs), killed once epoch 2's resume
                  state is saved, then resumed with --grad_cache 16; one f32
                  step at batch 8 on the card against the CPU, grad-cache
                  and remat against the monolithic step at batch 64, each
                  held to a float64 step of the same weights and views, with
                  K4/K5 launches counted (0: the trainable net takes the
                  differentiable route); ms per step, views/s and peak memory
                  in bf16 and f32 at batch 64 and 512 and at the reference's
                  4096 with --grad_cache 128; the busy share and the
                  normalization's share of a default step; the trained
                  model.pth through compute_feats' embedder (K5/K4 1/19)
 17. pool_bf16 -- K1-bf16 (the bf16 feature stream of K1) vs its plain
                  version at the kernel's rounding points (64-row tiles in
                  each CTA's range) at K=512, C=2, N up to 262144, its error
                  against the f32 K1, bitwise reruns, the times of the
                  kernel (and its share of the bound), the plain version,
                  the f32 -> bf16 cast of the bag and the f32 K1, ptxas's
                  registers and spills; then fused_bag_forward(feats_dtype=
                  bfloat16) on a DSMIL at N=65529 against the CPU, its
                  K1-bf16 launch counted, timed whole and by part
 18. pipeline  -- eight synthetic two-page TIFF slides of 1024^2: python -m
                  tpumil_torch.cli.pipeline --stages tile,simclr, then the
                  feats, train and maps stages through pipeline.main with
                  K5/K4 (and K1-K3) launches counted per stage; every
                  stage's artifacts, the resolved YAML's round trip, walls
 19. scale_out -- the training half of scale-out at world 1 on NCCL: 3
                  InstanceShardedBagTrainer steps against 3 eager BagTrainer
                  steps on the [train] bags of N=4000 and 65529 (params
                  within rtol 1e-3 / atol 2e-5, collective calls per step,
                  K1-K3 launches 0, ms per step in turns, peak bytes per
                  instance); train_wsi --inst_shard 1 and --data_parallel 1
                  on [train_wsi]'s dataset (the inst-sharded folds equal the
                  single-device run's); a sharded fold state crashed and
                  resumed mid-fold; --inst_shard 2 refused on one card; one
                  bf16 inst-sharded step at N=65529 against the unsharded
                  bf16 step from the same weights (loss gap within 2e-2,
                  weights within 2 lr)
 20. scale_out_embed -- the embedding half of scale-out at world 1 on
                  NCCL: FeatureExtractor(mesh) on 2 batches of 128 224^2
                  JPEGs bitwise the single-device features (and 37 rows
                  through embed_arrays), K5/K4 launches on the sharded path
                  (2 / 38), ms per batch against the single-device path in
                  turns, the host ms of its 3 collectives a batch; one
                  sharded SimCLR step (bf16, batch 64) against the
                  single-device one (loss rtol 1e-4, weights within 2 lr),
                  ms per step in turns; compute_feats --data_parallel 1 on
                  [compute_feats]'s tree (CSV bytes equal), attention_map
                  with and without --data_parallel 1 on one bag (equal
                  score CSVs), serve --data_parallel 1 answering /v1/embed
                  (rows bitwise the single-device service's, SIGTERM exits
                  0), simclr_train --data_parallel 1 for one epoch, and
                  --data_parallel 2 refused on one card
Then one JSON line of kernel results (each with its bound: the larger of
its bytes over the memory rate and its operations over the peak rate of
their type) and, last, the device JSON line.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
B = 128
IN_SHAPES = [(112, 64), (56, 64), (28, 128), (14, 256), (7, 512)]
# IN sites of one ResNet18-IN forward at 224^2 (the 112^2 stem plane is
# K5's): H = W -> count
IN_SITES = {56: 4, 28: 5, 14: 5, 7: 5}
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: both sum in f32 in other
# orders (test_in_pallas.py's 2e-5). bf16: the output is rounded to bf16, so
# the two may differ by one bf16 step (2^-7 relative).
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2 ** -7)}
# attention pool at the paper's width: ResNet18 features, TCGA lung classes
K, C = 512, 2
POOL_N = [(1000, 1000, True), (1000, 997, False), (65529, 65529, True),
          (262144, 262144, True)]
# |kernel - plain| <= rtol * max|plain| + 1e-6: sums over N rows in another
# order (per-block partials merged in block order); the backward's products
# of three sums get the looser bar
POOL_RTOL = {"B": 1e-4, "m": 1e-5, "s": 1e-4, "s_red": 1e-4, "grad": 1e-3}
# K1 and K3 run their q-MLP products in 3xTF32: at N = 65529 K1's B, m, s,
# K2's s_red and K3's gradients are also held to 1e-5 of max|plain|, which
# one TF32 pass misses by two orders of magnitude
K3_RTOL_F32 = 1e-5
# times of the earlier FFMA designs (PERF.md; K3 with dF always written),
# ms by N, on an NVIDIA H100 80GB HBM3 at 700 W
K3_FFMA_MS = {1000: 0.216, 65529: 4.600, 262144: 18.052}
K1_FFMA_MS = {1000: 0.072, 65529: 0.731, 262144: 2.801}
K2_FFMA_MS = {1000: 0.078, 65529: 0.833, 262144: 3.334}
# K5's earlier design (an FFMA conv writing the conv plane, then a pool and
# normalize pass), ms at B=128 on an NVIDIA H100 80GB HBM3 at 700 W: f32 in
# two runs, bf16
K5_FFMA_MS = {torch.float32: "1.122 / 1.182", torch.bfloat16: "0.965"}
# K1-bf16 against attention_pool_bf16_plain at the kernel's rounding points
# (64-row tiles in each CTA's range): h and q run as bf16 hi + lo (16 bits),
# so m, s and the logits carry ~1e-5 of their max; B also moves by one bf16
# spacing of a weight times |f| / s wherever a logit's error flips that
# weight's rounding (ap.bf16_rounding_slack)
BF16_RTOL = 1e-4
TRAIN_N = [1500, 4000, 9000, 20000, 40000, 65529]
TRAIN_EPOCHS = 3
# the compute_feats tree: classes x bags per class x patches of 224^2
CF_CLASSES, CF_BAGS, CF_PATCHES = 2, 3, 256
# the slide_feats slides: one per class, side^2 at 20x, tissue share of the
# area
SF_CLASSES, SF_SIDE, SF_TISSUE = 2, 4480, 0.6
# the attention_map bags (patches each; every last batch of 64 ragged) and
# the CLIs' batch
AM_BAGS, AM_BATCH = (600, 1000, 130), 64
# the pipeline's slides: per class, side^2 at 20x with a textured tissue
# square of tissue^2 in the corner (tests/test_pipeline_e2e.py's generator,
# grown to give ~16 tiles of 224^2 each)
PL_CLASSES, PL_SLIDES, PL_SIDE, PL_TISSUE = 2, 4, 1024, 800
# TransMIL's depthwise convs: the cohort's mean and largest bag sizes, and
# |kernel - plain| <= DW_RTOL * max|plain| (the PPEG's backward sums its
# merged 7x7 in another order than ATen's three convs)
DW_N = (6758, 65536)
DW_RTOL = 1e-5
# H100 SXM published peaks at 700 W (NVIDIA's data sheet, dense): memory
# bytes/s, and flop/s by operand type (f32 on the CUDA cores, bf16 on the
# tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# TF32 on the tensor cores: K3's 3xTF32 products do three per f32 product
TF32_FLOPS = 495e12


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` operations of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
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
    """Device time of fn() in ms: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events, so the host's launch cost (tens
    of microseconds per call in Python) does not hide a short kernel."""
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


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance (max abs err {err.max().item():.3e}, "
                             f"atol {atol}, rtol {rtol})")
    return err.max().item()


def conv_route_stem(x: torch.Tensor, w7: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The stem as ResNet runs it for inputs K5 does not take (cuDNN conv,
    K4 with ReLU, max pool), with fused_stem's NHWC/HWIO signature: the
    yardstick K5 replaces."""
    from tpumil_torch.models import resnet

    h = resnet._conv(x.permute(0, 3, 1, 2).to(dtype), w7.permute(3, 2, 0, 1),
                     2, dtype)
    return F.max_pool2d(resnet._instance_norm(h, True), 3, 2, 1) \
        .permute(0, 2, 3, 1)


def phase_device() -> str:
    gpu = gpu_line()
    log(f"[device] nvidia-smi: {gpu}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} capability {cap} "
        f"count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs a capability (9, 0) card, got {cap}")
    return gpu


def phase_build() -> str:
    """Build the kernels; returns the compiler's log (ptxas lines)."""
    from tpumil_torch.utils import build

    path, seconds, compiler_log = build.build(verbose=True)
    rel = os.path.relpath(path, REPO)
    srcs = [os.path.relpath(p, REPO) for p in build.sources()]
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)} {' '.join(srcs)} -> {rel} "
        f"in {seconds:.2f} s" + (" (cached)" if seconds == 0 else ""))
    for line in compiler_log.splitlines():
        if "Function properties for" in line:
            # the mangled kernel name, its template arguments after it
            log(f"[build]   ptxas: {line.split('for', 1)[1].strip()[:72]}")
        elif "registers" in line or "spill" in line:
            log(f"[build]   ptxas:   {line.strip()}")
    build.load_library()
    return compiler_log


def kernel_name(symbol: str) -> str:
    """``pool_bf16_kernel<1,2>`` from a mangled kernel symbol of csrc/
    (``_ZN..._GLOBAL__N__<hash>_<n>_<file>_cu_<hash><len><name>I...E...``)."""
    tail = symbol.split("_cu_", 1)[-1][8:]
    m = re.match(r"\d+(\w+?_kernel)(I(?:L\w+?E)+E)?", tail)
    if not m:
        return symbol[:40]
    args = re.findall(r"L\w(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_of(compiler_log: str, key: str):
    """ptxas's register, shared-memory and spill lines of the kernels whose
    mangled name holds ``key``."""
    out, keep = [], False
    for line in compiler_log.splitlines():
        if "Function properties for" in line:
            keep = key in line
            name = kernel_name(line.split("for", 1)[1].strip())
        elif keep and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def two_read_in(x: torch.Tensor, relu: bool) -> torch.Tensor:
    """K4's two-read route forced at any shape (the earlier design, now the
    route of planes too large for a cluster): the yardstick of the one-read
    route.
    A direct launch, not counted as a K4 launch of the path."""
    from tpumil_torch.ops.instance_norm import EPS, _DTYPE_CODES
    from tpumil_torch.utils.build import load_library

    y = torch.empty_like(x)
    n, h, w, c = x.shape
    err = load_library().tpumil_instance_norm(
        x.data_ptr(), y.data_ptr(), n, h * w, c, _DTYPE_CODES[x.dtype],
        int(relu), EPS, 0, c, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"two-read instance_norm: CUDA error {err}")
    return y


def phase_kernel(gpu: str) -> dict:
    """K4 against its plain version at the five ResNet18 shapes; device
    times of the planned route and of the two-read route per shape, and
    their sums over one forward's 19 IN sites."""
    from tpumil_torch.ops.instance_norm import (fused_instance_norm,
                                                instance_norm_plain,
                                                plan_instance_norm)

    rng = np.random.default_rng(0)
    max_err_f32 = 0.0
    mix = {dt: dict(ms=0.0, two_read=0.0, plain=0.0, lib=0.0, eager=0.0,
                    bytes=0) for dt in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for h, c in IN_SHAPES:
            x = torch.from_numpy(
                rng.standard_normal((B, h, h, c), np.float32) * 3 + 1
            ).to("cuda", dtype)
            plan = plan_instance_norm(x.shape, dtype)
            for relu in (False, True):
                got = fused_instance_norm(x, relu)
                torch.cuda.synchronize()
                want = instance_norm_plain(x, relu)
                err = check_close(f"IN {dtype} {h}x{h}x{c} relu={relu}", got,
                                  want, atol, rtol)
                if dtype == torch.float32:
                    max_err_f32 = max(max_err_f32, err)
                check_close(f"IN two-read {dtype} {h}x{h}x{c} relu={relu}",
                            two_read_in(x, relu), want, atol, rtol)
            if not torch.equal(fused_instance_norm(x, True), got):
                raise AssertionError(f"IN {dtype} {h}x{h}x{c}: a rerun is not "
                                     "bitwise equal")
            ms = graph_ms(lambda: fused_instance_norm(x, True))
            two = graph_ms(lambda: two_read_in(x, True))
            eager = cuda_ms(lambda: fused_instance_norm(x, True), 20)
            plain_ms = cuda_ms(lambda: instance_norm_plain(x, True), 5)
            # the one library call for the same function (relu off); the
            # port never calls it
            lib_ms = cuda_ms(lambda: F.instance_norm(x.permute(0, 3, 1, 2)),
                             20)
            io = 2 * nbytes(x)  # one read + one write
            bound_ms, _ = bound(io, 7 * x.numel(), dtype)
            sites = IN_SITES.get(h, 0)
            m = mix[dtype]
            for key, val in (("ms", ms), ("two_read", two), ("plain", plain_ms),
                             ("lib", lib_ms), ("eager", eager),
                             ("bytes", io)):
                m[key] += sites * val
            log(f"[kernel] IN [{B},{h},{h},{c}] {str(dtype)[6:]}: route "
                f"{plan.route} (cluster {plan.cluster}, {plan.cblock} "
                f"channels); max_abs_err {err:.3e} (atol {atol}, rtol "
                f"{rtol:.3g}), rerun bitwise equal; relu on, device ms: "
                f"kernel {ms:.4f} ({io / ms / 1e6:.0f} GB/s at 1R+1W, "
                f"{bound_ms / ms:.0%} of the {bound_ms:.4f} ms bound), "
                f"two-read route {two:.4f}; per call with host launch "
                f"{eager:.4f}; plain {plain_ms:.4f}, F.instance_norm (relu off) "
                f"{lib_ms:.4f}; sites per forward {sites}; {gpu}")
            del x, got, want
    # blank-tile planes: exactly constant, and constant + 1e-4 noise, on
    # every route and cluster size the five shapes take
    err = 0.0
    for h in (112, 56, 28, 14, 7):
        c = dict(IN_SHAPES)[h]
        x = np.full((2, h, h, c), 3.7, np.float32)
        x[1] += rng.standard_normal((h, h, c)).astype(np.float32) * 1e-4
        xt = torch.from_numpy(x).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            got = fused_instance_norm(xt.to(dtype), True)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
                raise AssertionError(f"constant {h}^2 plane ({dtype}): "
                                     "expected exact zeros")
        err = max(err, check_close(
            "IN near-constant plane", fused_instance_norm(xt, True),
            instance_norm_plain(xt, True), 2e-2, 0.0))
    log(f"[kernel] constant planes -> exact zeros on every shape and route; "
        f"near-constant planes max_abs_err {err:.3e} (atol 2e-2)")
    out = {}
    for dtype, m in mix.items():
        bound_ms, bound_by = bound(m["bytes"], 0, dtype)
        log(f"[kernel] one ResNet18-IN forward's 19 IN sites at B={B} "
            f"({str(dtype)[6:]}, relu; 4 x 56^2x64 + 5 x 28^2x128 + 5 x "
            f"14^2x256 + 5 x 7^2x512), device ms: kernel {m['ms']:.4f} "
            f"({bound_ms / m['ms']:.0%} of the bound), two-read route (the "
            f"earlier design) {m['two_read']:.4f}, bound {bound_ms:.4f} ({bound_by}: "
            f"{m['bytes']} B at 1R+1W); per call with host launch "
            f"{m['eager']:.4f}; plain {m['plain']:.4f}; F.instance_norm (relu "
            f"off) {m['lib']:.4f}; {gpu}")
        out[dtype] = {"ms": m["ms"], "plain_ms": m["plain"],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": m["lib"]}
    return {"max_abs_err": max_err_f32, **out[torch.float32]}


def phase_embedder(gpu: str) -> None:
    from tpumil_torch.models import embedder, resnet
    from tpumil_torch.ops import instance_norm, stem

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (B, 224, 224, 3), np.uint8)).to(dev)
    k4, k5 = instance_norm.fused_instance_norm, stem.fused_stem
    for precision in ("f32", "bf16"):
        cfg = embedder.EmbedderConfig(backbone="resnet18", norm="instance",
                                      precision=precision)
        model = embedder.init_params(0, cfg, dev)
        with torch.inference_mode():
            k4.launches = k5.launches = 0
            feats_k, _ = model(imgs)
            torch.cuda.synchronize()
            per_fwd = (k4.launches, k5.launches)
            ms_k = cuda_ms(lambda: model(imgs), 10)
            resnet.fused_instance_norm = instance_norm.instance_norm_plain
            resnet.fused_stem = stem.stem_plain
            try:
                feats_p, _ = model(imgs)
                ms_p = cuda_ms(lambda: model(imgs), 10)
            finally:
                resnet.fused_instance_norm, resnet.fused_stem = k4, k5
        if per_fwd != (19, 1):
            raise AssertionError(f"expected 19 K4 and 1 K5 launches per "
                                 f"ResNet18 forward, counted {per_fwd}")
        if feats_k.shape != (B, 512) or not torch.isfinite(feats_k).all():
            raise AssertionError(f"bad features {tuple(feats_k.shape)}")
        err = (feats_k - feats_p).abs().max().item()
        if precision == "f32":
            # 20 normalizations in another summation order (the
            # test_in_pallas.py forward-parity bar)
            check_close("embedder features", feats_k, feats_p, 1e-4, 1e-4)
            # the card against the port's CPU path, which the CPU tests hold
            # to the JAX package at the same bar
            ref = embedder.Embedder(cfg, torch.device("cpu"))
            ref.load_state_dict(model.state_dict())
            with torch.inference_mode():
                feats_cpu, _ = ref(imgs[:4].cpu())
            cpu_err = check_close("embedder card vs CPU", feats_k[:4].cpu(),
                                  feats_cpu, 1e-4, 1e-4)
            log(f"[embedder] resnet18-IN f32: card vs the CPU path on 4 "
                f"patches max_abs_err {cpu_err:.3e} (atol 1e-4, rtol 1e-4)")
        log(f"[embedder] resnet18-IN {precision} 224^2 B={B}: K4/K5 launches "
            f"per forward {per_fwd}; kernel route {ms_k:.3f} ms "
            f"({B / ms_k * 1e3:.0f} patches/s), plain route {ms_p:.3f} ms "
            f"({B / ms_p * 1e3:.0f} patches/s); feature max_abs_err {err:.3e}"
            f"{' (atol 1e-4, rtol 1e-4)' if precision == 'f32' else ''}; {gpu}")
        del model


def phase_golden() -> None:
    from tpumil_torch.io import torch_ckpt

    golden = np.load(os.path.join(REPO, "tests", "data",
                                  "golden_aggregator.npz"))
    for name in ("c16", "tcga"):
        model, cfg, _ = torch_ckpt.load_mil_pth(
            os.path.join(REPO, "tests", "data", f"{name}_aggregator.pth"),
            torch.device("cuda"))
        with torch.inference_mode():
            c, bag, attn, _ = model(
                torch.from_numpy(golden[f"{name}_feats"]).cuda())
        np.testing.assert_allclose(bag.cpu().numpy()[None],
                                   golden[f"{name}_bag_logits"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(attn.cpu().numpy(),
                                   golden[f"{name}_attention"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(c.cpu().numpy(),
                                   golden[f"{name}_ins_logits"],
                                   rtol=1e-4, atol=1e-5)
        log(f"[golden] {name} aggregator matches the reference outputs "
            f"(rtol 1e-4, atol 1e-5/1e-6)")


def phase_serve(gpu: str) -> int:
    from tpumil_torch.cli import serve
    from tpumil_torch.infer.client import ServingClient
    from tpumil_torch.models import embedder
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem

    rng = np.random.default_rng(2)
    n_embed, n_pp = 300, 200
    embed_imgs = rng.integers(0, 256, (n_embed, 224, 224, 3), np.uint8)
    pp_imgs = rng.integers(0, 256, (n_pp, 224, 224, 3), np.uint8)
    hm_imgs = rng.integers(0, 256, (64, 224, 224, 3), np.uint8)
    hm_pos = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    bag = rng.standard_normal((20_000, 512)).astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "embedder.pth")
        cfg = embedder.EmbedderConfig(backbone="resnet18", num_classes=2)
        src = embedder.init_params(0, cfg, torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(src), ckpt)
        args = serve.parse_args([
            "--embedder_weights", ckpt,
            "--aggregator_weights",
            os.path.join(REPO, "tests", "data", "tcga_aggregator.pth"),
            "--num_classes", "2", "--device", "cuda", "--precision", "f32",
            "--batch_size", str(B)])
        # the serving path starts here
        fused_instance_norm.launches = fused_stem.launches = 0
        t0 = time.perf_counter()
        service = serve.build_service(args)
        log(f"[serve] service built (load + warm-up) in "
            f"{time.perf_counter() - t0:.2f} s")
        server = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = server.server_address[:2]
            client = ServingClient(f"http://{host}:{port}", timeout=600)
            results, latency, errors = {}, {}, []

            def call(name, fn):
                try:
                    t = time.perf_counter()
                    results[name] = fn()
                    latency[name] = time.perf_counter() - t
                except BaseException as exc:  # noqa: BLE001 - re-raised below
                    errors.append((name, exc))

            calls = {
                "embed": lambda: client.embed(embed_imgs),
                "predict_patches": lambda: client.predict_patches(
                    pp_imgs, attention=True),
                "predict": lambda: client.predict(bag, attention=True),
                "heatmap": lambda: client.heatmap(hm_imgs, hm_pos),
            }
            threads = [threading.Thread(target=call, args=item)
                       for item in calls.items()]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors:
                raise RuntimeError(f"serve requests failed: {errors}")
            if any(t.is_alive() for t in threads):
                raise RuntimeError("a serve request did not finish in 600 s")

            # throughput: 4 concurrent clients x 512 patches on /v1/embed
            tp_imgs = rng.integers(0, 256, (512, 224, 224, 3), np.uint8)
            tp_threads = [threading.Thread(
                target=call, args=(f"tp{i}", lambda: client.embed(tp_imgs)))
                for i in range(4)]
            t0 = time.perf_counter()
            for t in tp_threads:
                t.start()
            for t in tp_threads:
                t.join(timeout=600)
            tp_wall = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in tp_threads):
                raise RuntimeError(f"throughput requests failed: {errors}")

            stats = client.stats()
            health = client.health()
            launches = fused_instance_norm.launches
            k5_launches = fused_stem.launches
        finally:
            server.shutdown()
            server.server_close()
            service.close()

        # -- checks ----------------------------------------------------------
        feats = results["embed"]
        if feats.shape != (n_embed, 512) or not np.isfinite(feats).all():
            raise AssertionError(f"embed: bad features {feats.shape}")
        with torch.inference_mode():
            direct = []
            for s in range(0, n_embed, B):
                buf = np.zeros((B, 224, 224, 3), np.uint8)
                chunk = embed_imgs[s:s + B]
                buf[:len(chunk)] = chunk
                f, _ = service.embedder(torch.from_numpy(buf))
                direct.append(f.cpu().numpy()[:len(chunk)])
            direct = np.concatenate(direct)
            agg = service.aggregator
            _, bag_logits, attn, _ = agg(torch.from_numpy(bag).cuda())
            want_scores = torch.sigmoid(bag_logits).cpu().numpy()
        np.testing.assert_allclose(feats, direct, rtol=0, atol=1e-5)
        bitwise = bool(np.array_equal(feats, direct))
        pp = results["predict_patches"]
        pr = results["predict"]
        hm = results["heatmap"]
        for name, out, n in (("predict_patches", pp, n_pp),
                             ("predict", pr, bag.shape[0])):
            att = np.asarray(out["attention"])
            if (len(out["scores"]) != 2 or att.shape != (n, 2)
                    or not np.isfinite(att).all()
                    or not all(0.0 <= s <= 1.0 for s in out["scores"])):
                raise AssertionError(f"{name}: bad response {out['scores']} "
                                     f"{att.shape}")
        np.testing.assert_allclose(pr["scores"], want_scores, rtol=0, atol=1e-5)
        if hm["png"][:8] != b"\x89PNG\r\n\x1a\n" or len(hm["scores"]) != 2:
            raise AssertionError("heatmap: bad PNG response")
        if stats["errors"] != 0:
            raise AssertionError(f"/stats reports errors: {stats}")
        if health["backend"] != "cuda":
            raise AssertionError(f"/healthz backend {health['backend']}")
        if launches == 0 or k5_launches == 0:
            raise AssertionError(f"the serving path launched K4 {launches} and "
                                 f"K5 {k5_launches} times")
        log(f"[serve] embed rows vs in-process forward: max_abs_err "
            f"{np.abs(feats - direct).max():.3e} (atol 1e-5), bitwise equal: "
            f"{bitwise}")
        log(f"[serve] all 4 routes answered 200; /stats {json.dumps(stats)}; "
            f"K4 launches {launches}, K5 launches {k5_launches}")
        lat = ", ".join(f"{k} {latency[k] * 1e3:.1f} ms" for k in calls)
        log(f"[serve] concurrent latencies: {lat}; wall {wall * 1e3:.1f} ms "
            f"({n_embed} patches/embed: {n_embed / latency['embed']:.0f} "
            f"patches/s); {gpu}")
        log(f"[serve] embed throughput: 4 clients x 512 patches in "
            f"{tp_wall:.3f} s = {2048 / tp_wall:.0f} patches/s; {gpu}")
        return launches


def pool_err(name: str, got: torch.Tensor, want: torch.Tensor,
             rtol: float) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    bar = rtol * want.abs().max().item() + 1e-6
    if err > bar:
        raise AssertionError(f"{name}: max abs err {err:.3e} > {bar:.3e}")
    return err


def pool_inputs(n: int, nonlinear: bool, seed: int):
    """Seeded bag and weights at K, C. For the nonlinear q every row keeps
    |z1| > 1e-5 (float64) off the ReLU's kink, where the gradient jumps and
    two f32 computations of z1 may take opposite sides (about one of the
    8.4M z1 values at N = 65529 lies within f32 rounding of 0)."""
    from tpumil_torch.ops.attention_pool import ATTN_DIM as D

    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale

    w = [t(D, K, scale=0.05), t(D, scale=0.1),
         t(D, D, scale=0.1) if nonlinear else None,
         t(D, scale=0.1) if nonlinear else None]
    feats = t(n + n // 20 + 64, K, scale=1.0)
    if nonlinear:
        z1 = feats.double() @ w[0].double().T + w[1].double()
        feats = feats[z1.abs().amin(dim=1) > 1e-5]
        del z1
    if feats.shape[0] < n:
        raise AssertionError("too few rows off the ReLU's kink")
    return feats[:n].contiguous(), w, t(C, D, scale=0.5), t(C, K, scale=1.0)


def pool_flops(n: int, d: int, nonlinear: bool) -> dict:
    """Operations of K1, K2, K3 on one bag of n x K instances (K3 with and
    without dF); "mlp" is K1's share on the tensor cores."""
    mlp = 2 * n * K * d + (2 * n * d * d if nonlinear else 0) \
        + 2 * n * C * d                      # q-MLP, logits against q_max
    # + dA's f . dB, dlogits -> dq and dq_max, the MLP's backward (dW0;
    # dW2 and dh through W2)
    bwd2 = mlp + 2 * n * C * K + 4 * n * C * d + 2 * n * K * d \
        + (4 * n * d * d if nonlinear else 0)
    return {
        "mlp": mlp,
        "fwd": mlp + 2 * n * C * K,          # + B = A^T f
        "bwd1": 2 * n * C * K,               # f . dB, from K1's logits
        "bwd2": bwd2 + 2 * n * C * K + 2 * n * K * d,  # + dF = A dB + dz1 W0
        "bwd2_nodf": bwd2}


def phase_pool(gpu: str) -> dict:
    """K1, K2, K3 against their plain versions; times and bounds at each
    N. K3 with dF written and skipped. The bounds of K1 and K3 count their
    q-MLP products as 3xTF32 (three TF32 products per f32 product) on the
    tensor cores; K2 is one read of the bag."""
    from tpumil_torch.ops import attention_pool as ap

    worst = {"fwd": 0.0, "bwd1": 0.0, "bwd2": 0.0}
    times, bounds = {}, {}
    names = ("dF", "dW0", "db0", "dW2", "db2", "dq_max")
    for i, (n, n_valid, nonlinear) in enumerate(POOL_N):
        feats, w, qm, db = pool_inputs(n, nonlinear, i)
        args = (feats, *w, qm)
        out, m, s, lg = ap.attention_pool_fwd(*args, n_valid, nonlinear)
        torch.cuda.synchronize()
        want = ap.attention_pool_plain(*args, n_valid, nonlinear)

        def rtol(name):
            return min(POOL_RTOL[name], K3_RTOL_F32) if n == 65529 \
                else POOL_RTOL[name]

        # K1's reported error is its output B's; the residuals m, s and the
        # logits (valid rows; the padded ones exactly -1e30) are held to
        # their bars too
        e1, _, _ = [pool_err(f"K1 {nm} N={n}", g, x, rtol(nm))
                    for nm, g, x in zip(("B", "m", "s"), (out, m, s), want)]
        _, wm, ws, wl = want
        pool_err(f"K1 logits N={n}", lg[:n_valid], wl[:n_valid],
                 POOL_RTOL["m"])
        if not torch.equal(lg[n_valid:], wl[n_valid:]):
            raise AssertionError(f"K1 N={n}: padded rows' logits not -1e30")
        red = ap.attention_pool_bwd1(feats, wl, wm, ws, db, n_valid)
        torch.cuda.synchronize()
        want_red = ap.attention_pool_bwd1_plain(feats, wl, wm, ws, db,
                                                n_valid)
        e2 = pool_err(f"K2 s_red N={n}", red, want_red, rtol("s_red"))
        again = ap.attention_pool_fwd(*args, n_valid, nonlinear)
        if not all(torch.equal(a, b) for a, b in zip((out, m, s, lg), again)) \
                or not torch.equal(red, ap.attention_pool_bwd1(
                    feats, wl, wm, ws, db, n_valid)):
            raise AssertionError(f"K1/K2 N={n}: a rerun is not bitwise equal")
        del again
        bargs = (*args, wm, ws, db, want_red, n_valid, nonlinear)
        grads = ap.attention_pool_bwd2(*bargs)
        torch.cuda.synchronize()
        want_g = ap.attention_pool_bwd2_plain(*bargs)
        used = [(nm, g, x) for nm, g, x in zip(names, grads, want_g)
                if nonlinear or nm not in ("dW2", "db2")]
        e3 = max(pool_err(f"K3 {nm} N={n}", g, x, POOL_RTOL["grad"])
                 for nm, g, x in used)
        # relative to max|plain| for the outputs that are not zero up to
        # rounding (the linear q's db0 sums to 0 analytically)
        rel3 = max((g - x).abs().max().item() / x.abs().max().item()
                   for _, g, x in used if x.abs().max().item() > 1e-6)
        if n == 65529 and rel3 > K3_RTOL_F32:
            raise AssertionError(f"K3 N={n}: max err {rel3:.3e} of max|plain| "
                                 f"> {K3_RTOL_F32}")
        if grads[0][n_valid:].any():
            raise AssertionError("K3 wrote nonzero dF rows past n_valid")
        skipped = ap.attention_pool_bwd2(*bargs, need_df=False)
        if skipped[0] is not None or not all(
                torch.equal(a, b) for a, b in zip(grads[1:], skipped[1:])):
            raise AssertionError(f"K3 N={n}: the gradients without dF differ "
                                 "from those with dF")
        if not all(torch.equal(a, b) for a, b in
                   zip(grads, ap.attention_pool_bwd2(*bargs))):
            raise AssertionError(f"K3 N={n}: a rerun is not bitwise equal")
        del want_g, skipped
        iters = 20 if n <= 65536 else 5
        ms = {
            "fwd": cuda_ms(lambda: ap.attention_pool_fwd(
                *args, n_valid, nonlinear), iters),
            "fwd_plain": cuda_ms(lambda: ap.attention_pool_plain(
                *args, n_valid, nonlinear), iters),
            "bwd1": cuda_ms(lambda: ap.attention_pool_bwd1(
                feats, wl, wm, ws, db, n_valid), iters),
            "bwd1_plain": cuda_ms(lambda: ap.attention_pool_bwd1_plain(
                feats, wl, wm, ws, db, n_valid), iters),
            "bwd2": cuda_ms(lambda: ap.attention_pool_bwd2(*bargs), iters),
            "bwd2_plain": cuda_ms(lambda: ap.attention_pool_bwd2_plain(
                *bargs), iters),
            "bwd2_nodf": cuda_ms(lambda: ap.attention_pool_bwd2(
                *bargs, need_df=False), iters),
            "bwd2_nodf_plain": cuda_ms(lambda: ap.attention_pool_bwd2_plain(
                *bargs, need_df=False), iters),
        }
        for key, err in (("fwd", e1), ("bwd1", e2), ("bwd2", e3)):
            worst[key] = max(worst[key], err)
        flops = pool_flops(n_valid, ap.ATTN_DIM, nonlinear)
        io = {"fwd": nbytes(*args, out, m, s, lg),
              "bwd1": nbytes(feats, wl, wm, ws, db, red),
              "bwd2": nbytes(*bargs[:-2], *grads),
              "bwd2_nodf": nbytes(*bargs[:-2], *grads[1:])}
        bd = {"bwd1": bound(io["bwd1"], flops["bwd1"])}
        ffma = {}
        for key in ("fwd", "bwd2", "bwd2_nodf"):
            ffma[key] = bound(io[key], flops[key])[0]
            # K1: the q-MLP and logits as 3xTF32, its pooling in f32 FFMA
            t_ops = 3 * flops[key] / TF32_FLOPS if key != "fwd" else \
                3 * flops["mlp"] / TF32_FLOPS \
                + (flops["fwd"] - flops["mlp"]) / PEAK_FLOPS[torch.float32]
            t_bytes = io[key] / HBM_BYTES_PER_S
            bd[key] = (max(t_ops, t_bytes) * 1e3,
                       "operations" if t_ops >= t_bytes else "bytes")
        if nonlinear:
            times[n], bounds[n] = ms, bd
        log(f"[pool] N={n} bound ms (by): " + ", ".join(
            f"{name} {bd[key][0]:.4f} ({bd[key][1]}: {flops[key]} flop, "
            f"{io[key]} B)" for name, key in (("K1", "fwd"), ("K2", "bwd1"),
                                                ("K3", "bwd2"),
                                                ("K3 without dF", "bwd2_nodf")))
            + f"; at f32 FFMA rates K1 {ffma['fwd']:.4f}, K3 "
            f"{ffma['bwd2']:.4f} (without dF {ffma['bwd2_nodf']:.4f})")
        f32 = f"; {K3_RTOL_F32} at N=65529" if n == 65529 else ""
        log(f"[pool] N={n} n_valid={n_valid} K={K} C={C} nonlinear="
            f"{int(nonlinear)}: max_abs_err K1 {e1:.3e} (rtol {POOL_RTOL['B']} "
            f"of max|plain|{f32}), K2 {e2:.3e} (rtol {POOL_RTOL['s_red']}"
            f"{f32}), K3 {e3:.3e} (rtol {POOL_RTOL['grad']}; {rel3:.2e} of "
            f"max|plain|{f', bar {K3_RTOL_F32}' if n == 65529 else ''}), "
            f"K1 logits within rtol {POOL_RTOL['m']}, K3 without dF bitwise "
            f"equal, K1-K3 reruns bitwise equal; ms kernel/plain: K1 "
            f"{ms['fwd']:.3f}/{ms['fwd_plain']:.3f}, K2 {ms['bwd1']:.3f}/"
            f"{ms['bwd1_plain']:.3f}, K3 {ms['bwd2']:.3f}/"
            f"{ms['bwd2_plain']:.3f}, K3 without dF {ms['bwd2_nodf']:.3f}/"
            f"{ms['bwd2_nodf_plain']:.3f}"
            + (f" (the earlier FFMA designs: K1 {K1_FFMA_MS[n]:.3f}, K2 "
               f"{K2_FFMA_MS[n]:.3f}, K3 with dF always written "
               f"{K3_FFMA_MS[n]:.3f})" if nonlinear and n in K3_FFMA_MS
               else "") + f"; {gpu}")
        del feats, w, qm, db, out, lg, red, grads, want
        torch.cuda.empty_cache()
    return {"err": worst, "ms": times[65529], "bound": bounds[65529]}


def aligned_zero_fill(feats, w0, dtype):
    """``ops/attention_pool._aligned`` before its one-copy cast (a
    zero-filled bag, then a copy into it): the cast's yardstick."""
    k = feats.shape[1]
    per = 16 // torch.empty((), dtype=dtype).element_size()
    kp = -(-k // per) * per
    if kp == k and feats.data_ptr() % 16 == 0 and feats.dtype == dtype:
        return feats, w0.to(dtype)
    padded = feats.new_zeros((feats.shape[0], kp), dtype=dtype)
    padded[:, :k] = feats
    if kp != k:
        w0 = F.pad(w0, (0, kp - k))
    return padded, w0.to(dtype)


def phase_pool_bf16(gpu: str, compiler_log: str) -> dict:
    """K1-bf16 against its plain version at the kernel's rounding points
    (64-row tiles, the CTA ranges of bf16_segment_rows) at POOL_N, its error
    against the f32 K1 on the same bag, bitwise reruns, times (the kernel
    and its share of the bytes bound, the plain version, the f32 -> bf16
    cast of the bag, the f32 K1) and ptxas's lines of its kernels; then the
    path: fused_bag_forward(feats_dtype=bfloat16) on a DSMIL at the paper's
    width and N = 65529, its launches counted, against the CPU's forward,
    timed whole and by part, with _aligned's cast beside the zero-fill one."""
    from tpumil_torch.models.dsmil import DSMIL, DSMILConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.ops.masked import masked_max
    from tpumil_torch.utils.build import load_library

    bf = torch.bfloat16
    smem = load_library().tpumil_attention_pool_fwd_bf16_smem
    log(f"[pool_bf16] K1-bf16 kernels (ptxas): "
        f"{'; '.join(ptxas_of(compiler_log, 'bf16')) or 'not built here'}; "
        f"dynamic shared memory {smem(1)} B (nonlinear q), {smem(0)} B "
        f"(linear)")
    worst, out = 0.0, {}
    for i, (n, n_valid, nonlinear) in enumerate(POOL_N):
        feats, w, qm, _ = pool_inputs(n, nonlinear, 40 + i)
        f32_args = (feats, *w, qm)
        args = (feats.to(bf), w[0].to(bf), w[1],
                None if w[2] is None else w[2].to(bf), w[3], qm.to(bf))
        rows = ap.bf16_segment_rows(feats.device, n_valid)
        points = dict(tile_n=ap.BF16_TILE, segment_rows=rows)
        got = ap.attention_pool_fwd_bf16(*args, n_valid, nonlinear)
        torch.cuda.synchronize()
        want = ap.attention_pool_bf16_plain(*args, n_valid, nonlinear,
                                            **points)
        slack = ap.bf16_rounding_slack(args[0], want[3], got[3], want[1],
                                       want[2], n_valid, **points).max().item()
        e_b = pool_err(f"K1-bf16 B N={n}", got[0], want[0],
                       BF16_RTOL + slack / want[0].abs().max().item())
        for nm, g, x in (("m", got[1], want[1]), ("s", got[2], want[2]),
                         ("logits", got[3][:n_valid], want[3][:n_valid])):
            pool_err(f"K1-bf16 {nm} N={n}", g, x, BF16_RTOL)
        if not (got[3][n_valid:] == ap.NEG_INF).all():
            raise AssertionError(f"K1-bf16 N={n}: padded logits not -1e30")
        if not all(torch.equal(a, b) for a, b in zip(
                got, ap.attention_pool_fwd_bf16(*args, n_valid, nonlinear))):
            raise AssertionError(f"K1-bf16 N={n}: a rerun is not bitwise "
                                 "equal")
        f32 = ap.attention_pool_fwd(*f32_args, n_valid, nonlinear)
        vs32 = [((g - x)[:n_valid].abs().max() / x[:n_valid].abs().max())
                .item() for g, x in zip(got, f32)]
        worst = max(worst, e_b)
        iters = 20 if n <= 65536 else 5
        # the kernel's device time from a CUDA graph of its launches: back to
        # back from Python, the wrapper's host time (~0.08 ms) hides it
        run = lambda: ap.attention_pool_fwd_bf16(  # noqa: E731
            *args, n_valid, nonlinear)
        ms = {"kernel": graph_ms(run),
              "events": cuda_ms(run, 5 * iters),
              "plain": cuda_ms(lambda: ap.attention_pool_bf16_plain(
                  *args, n_valid, nonlinear, **points), iters),
              "cast": cuda_ms(lambda: feats.to(bf), iters),
              "f32": cuda_ms(lambda: ap.attention_pool_fwd(
                  *f32_args, n_valid, nonlinear), iters)}
        # the function's operations (q-MLP, logits, B = p^T f) as bf16
        # products; its bytes: each input read once, each output written once
        flops = pool_flops(n_valid, ap.ATTN_DIM, nonlinear)["fwd"]
        bd = bound(nbytes(*args, *got), flops, bf)
        cast_bd = bound(nbytes(feats, args[0]), 0)
        log(f"[pool_bf16] N={n} n_valid={n_valid} K={K} C={C} nonlinear="
            f"{int(nonlinear)}, {rows} rows per CTA: max_abs_err B {e_b:.3e} "
            f"(bar {BF16_RTOL} of max|plain| + rounding slack {slack:.2e}; "
            f"max|B| {want[0].abs().max().item():.3e}), m, s, logits within "
            f"{BF16_RTOL} of max|plain|, padded logits -1e30, rerun bitwise "
            f"equal; against the f32 K1 (the bf16 error's size, of max|f32|): "
            f"B {vs32[0]:.2e}, m {vs32[1]:.2e}, s {vs32[2]:.2e}, logits "
            f"{vs32[3]:.2e}; ms kernel {ms['kernel']:.4f} by CUDA graph "
            f"({bd[0] / ms['kernel']:.1%} of the bound, "
            f"{nbytes(*args, *got) / ms['kernel'] / 1e6:.0f} GB/s; "
            f"{ms['events']:.4f} by events around back-to-back calls), plain "
            f"{ms['plain']:.4f}, f32 -> bf16 cast of the bag "
            f"{ms['cast']:.4f} (bound {cast_bd[0]:.4f}), f32 K1 {ms['f32']:.4f};"
            f" bound {bd[0]:.4f} ms ({bd[1]}: {flops} flop, "
            f"{nbytes(*args, *got)} B); {gpu}")
        if n == 65529:
            out = {"ms": ms, "bound": bd}
        del feats, w, qm, args, f32_args, got, want, f32
        torch.cuda.empty_cache()

    # the path: the giant-bag eval forward with a bf16 feature stream
    n = 65529
    torch.manual_seed(7)
    model = DSMIL(DSMILConfig(feats_size=K, num_classes=C), torch.device("cpu"))
    feats = torch.randn(n, K, generator=torch.Generator().manual_seed(8)) * 0.5
    want = ap.fused_bag_forward(model, feats, feats_dtype=bf)
    f32_want = ap.fused_bag_forward(model, feats)
    model = model.cuda()
    dev_feats = feats.cuda()
    ap.attention_pool_fwd_bf16.launches = 0
    got = ap.fused_bag_forward(model, dev_feats, feats_dtype=bf)
    torch.cuda.synchronize()
    launches = ap.attention_pool_fwd_bf16.launches
    if launches != 1:
        raise AssertionError(f"fused_bag_forward(bf16) launched K1-bf16 "
                             f"{launches} times")
    # the forward whole and by part (the parts in fused_bag_forward's order)
    with torch.no_grad():
        w0, b0, w2, b2 = ap._q_weights(model)
        c_logits, mask, q_max = ap._instance_stream(model, dev_feats, n)
        fb, w0b = ap._aligned(dev_feats, w0, bf)
        pool_args = (fb, w0b, b0, w2.to(bf), b2, q_max.to(bf), n)
        bemb = ap.attention_pool_fwd_bf16(*pool_args)[0]
        parts = {
            "whole": lambda: ap.fused_bag_forward(model, dev_feats,
                                                  feats_dtype=bf),
            "instance stream": lambda: ap._instance_stream(model, dev_feats,
                                                           n),
            "_aligned": lambda: ap._aligned(dev_feats, w0, bf),
            "K1-bf16": lambda: ap.attention_pool_fwd_bf16(*pool_args),
            "head": lambda: (model.bag_head(bemb),
                             masked_max(c_logits, mask, dim=0)),
            "_aligned by zero fill": lambda: aligned_zero_fill(dev_feats, w0,
                                                               bf)}
        path_ms = {k: cuda_ms(fn, 20) for k, fn in parts.items()}
    # the CPU rounds the weights per 1024-row tile against the running max,
    # the card per 64-row tile in each CTA's range: a weight's two roundings
    # differ by at most 2^-7 of it, independently from row to row, so the
    # bag logit d = sum_c sum_n p_nc g_dcn / s_c (g_dcn = sum_k W_dck f_nk)
    # moves with a standard deviation below sigma_d = 2^-7 sqrt(sum (p_nc
    # g_dcn / s_c)^2); the bar is 6 sigma_d plus f32 sums (1e-5)
    model = model.cpu()
    with torch.no_grad():
        crit = model.i_classifier.fc(feats).argmax(dim=0)
        q_max = model.b_classifier.q(feats[crit])
        w0, b0, w2, b2 = ap._q_weights(model)
        _, pm, ps, pl = ap.attention_pool_bf16_plain(
            feats, w0, b0, w2, b2, q_max, n)
        g = torch.einsum("nk,dck->ndc", feats.to(bf).float(),
                         model.b_classifier.fcc.weight)
        sigma = 2 ** -7 * ((torch.exp(pl - pm) / ps)[:, None, :] * g) \
            .square().sum(dim=(0, 2)).sqrt()
        bar = 6 * sigma + 1e-5 * (1 + want[0].abs())
    gap = (got[0].cpu() - want[0]).abs()
    if (gap > bar).any() or not torch.isfinite(got[0]).all():
        raise AssertionError(f"fused_bag_forward(bf16): bag logits "
                             f"{got[0].tolist()} vs CPU {want[0].tolist()}, "
                             f"bar {bar.tolist()}")
    e_max = pool_err("fused_bag_forward(bf16) max instance logits",
                     got[1].cpu(), want[1], 1e-5)
    log(f"[pool_bf16] fused_bag_forward(feats_dtype=bfloat16), DSMIL K={K} "
        f"C={C} nonlinear q, N={n}: K1-bf16 launches {launches}; bag logits "
        f"{[round(x, 6) for x in got[0].tolist()]} against the CPU's "
        f"{gap.max().item():.3e} (bar {bar.max().item():.3e}, 6 sigma of the "
        f"two rounding points' gap: the CPU rounds per 1024-row tile), "
        f"against the f32 forward "
        f"{(got[0].cpu() - f32_want[0]).abs().max().item():.3e}; max instance "
        f"logits {e_max:.1e} (rtol 1e-5); device ms on the f32 bag: "
        + ", ".join(f"{k} {v:.4f}" for k, v in path_ms.items()) + f"; {gpu}")
    out.update(launches=launches, err=worst)
    return out


def synthetic_bags(sizes, seed: int, k: int = K, c: int = C):
    """Bags whose positives hold witness instances shifted along a class
    direction, so that training has a signal to find."""
    from tpumil_torch.data.bags import Bag

    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((c, k)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bags = []
    for i, n in enumerate(sizes):
        x = rng.standard_normal((n, k), np.float32)
        cls = i % c
        x[:max(1, n // 10)] += 3.0 * dirs[cls]
        bags.append(Bag(x, np.eye(c, dtype=np.float32)[cls], f"bag{i}"))
    return bags


def step_ms(trainer, model, opt, feats, label, fused: bool,
            iters: int = 5) -> float:
    """Host-clock ms of one bag step (forward, backward, Adam), synced."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer._train_bags(model, opt, [(feats, label)] * 2, fused, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._train_bags(model, opt, [(feats, label)] * iters, fused, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def peak_bytes(fn) -> int:
    """Peak allocated bytes of fn() above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_train(gpu: str) -> dict:
    """The training path at full width: the kernel route against the eager
    route, from the same init and host RNG seed."""
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.train.trainer import BagTrainer, memory_budget_bytes

    dev = torch.device("cuda")
    cfg = DSMILConfig(K, C)
    store = DeviceBagStore(synthetic_bags(TRAIN_N, 3), device=dev)
    runs, counts = {}, None
    for route, thr in (("kernel", 16384), ("eager", None)):
        trainer = BagTrainer(cfg, weight_decay=1e-3, fused_threshold=thr,
                             device=dev)
        model, opt = trainer.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(7)
        kernels = (ap.attention_pool_fwd, ap.attention_pool_bwd1,
                   ap.attention_pool_bwd2)
        for fn in kernels:  # the training path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        losses, scores = [], None
        for epoch in range(TRAIN_EPOCHS):
            model, opt, loss = trainer.train_epoch(model, opt, store,
                                                   1e-4 / (epoch + 1), rng)
            scores, _ = trainer.predict(model, store, rng=rng)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if route == "kernel":
            counts = [fn.launches for fn in kernels]
        runs[route] = (losses, {k: v.cpu() for k, v in
                                model.state_dict().items()}, scores)
        log(f"[train] {route} route (fused_threshold={thr}): "
            f"{TRAIN_EPOCHS} epochs x {store.num_bags} bags of N in "
            f"{TRAIN_N} + predict in {wall:.2f} s; losses "
            f"{[f'{x:.6f}' for x in losses]}; fused dispatches "
            f"{trainer.fused_dispatches}")
        if route == "kernel" and trainer.fused_dispatches == 0:
            raise AssertionError("the kernel route dispatched no bucket "
                                 "to K1-K3")
    (l_k, p_k, s_k), (l_e, p_e, s_e) = runs["kernel"], runs["eager"]
    np.testing.assert_allclose(l_k, l_e, rtol=2e-4)
    for name in p_k:
        np.testing.assert_allclose(p_k[name].numpy(), p_e[name].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(s_k, s_e, rtol=0, atol=1e-4)
    if s_k.shape != (store.num_bags, C) or not np.isfinite(s_k).all():
        raise AssertionError(f"bad scores {s_k.shape}")
    if min(counts) == 0:
        raise AssertionError(f"K1/K2/K3 launches on the training path: {counts}")
    log(f"[train] kernel vs eager route: losses rtol 2e-4, params rtol 1e-3 "
        f"atol 2e-5, scores atol 1e-4 -- all hold; max |d score| "
        f"{np.abs(s_k - s_e).max():.3e}; K1/K2/K3 launches {counts}")

    # one bag step at N = 65529, both routes, same bag
    big = TRAIN_N.index(65529)
    feats, label = store.bag(big), store.label(big)
    trainer = BagTrainer(cfg, weight_decay=1e-3, fused_threshold=16384,
                         device=dev)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    ms_k = step_ms(trainer, model, opt, feats, label, True)
    ms_e = step_ms(trainer, model, opt, feats, label, False)
    ms_k2 = step_ms(trainer, model, opt, feats, label, True)
    ms_e2 = step_ms(trainer, model, opt, feats, label, False)
    log(f"[train] one bag step at N=65529 (host clock, synced, mean of 5): "
        f"kernel route {ms_k:.3f} / {ms_k2:.3f} ms, eager route "
        f"{ms_e:.3f} / {ms_e2:.3f} ms; {gpu}")

    # the eager step's and the eval forward's working set per instance: the
    # slope of the peak over two bag sizes
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = (16384, 65529)
    step = [peak_bytes(lambda: trainer._train_bags(
        model, opt, [(store.feats[:n], label)], False, gen)) for n in sizes]
    fstep = [peak_bytes(lambda: trainer._train_bags(
        model, opt, [(store.feats[:n], label)], True, gen)) for n in sizes]
    ev = [peak_bytes(lambda: trainer._eval_bags(
        model, [(store.feats[:n], label)], False, gen)) for n in sizes]
    dn = sizes[1] - sizes[0]
    slope = {"step": (step[1] - step[0]) / dn, "fused": (fstep[1] - fstep[0]) / dn,
             "eval": (ev[1] - ev[0]) / dn}
    log(f"[train] peak bytes above residents at N={sizes}: eager step {step}, "
        f"kernel step {fstep}, eager eval {ev}; per instance: eager step "
        f"{slope['step']:.0f} B, kernel step {slope['fused']:.0f} B, eval "
        f"{slope['eval']:.0f} B (K={K}); {gpu}")
    auto = BagTrainer(cfg, device=dev)
    log(f"[train] auto route for the 65536 bucket beside this store "
        f"({store.nbytes()} B): {'kernels' if auto._use_fused(65536, store.nbytes()) else 'eager'}"
        f" (budget {memory_budget_bytes(dev)} B)")
    train_bf16(gpu, store, l_e)
    return {"launches": counts}


def step_device_ms(trainer, model, opt, feats, label, steps: int = 5):
    """Device-busy ms per eager bag step (the union of the device intervals
    in a torch.profiler trace of ``steps`` synced steps), or None when the
    trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    from tools.serve_profile import busy_us, device_events

    gen = torch.Generator(device="cuda").manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer._train_bags(model, opt, [(feats, label)] * steps, False, gen)
        torch.cuda.synchronize()
    events = device_events(prof)
    return busy_us(events) / steps / 1e3 if events else None


def train_bf16(gpu: str, store, eager_losses) -> None:
    """The aggregator's bf16 compute dtype at the paper's width: BagTrainer
    with a bf16 DSMILConfig from [train]'s init and host seed (eager, never
    K1-K3, whatever fused_threshold says); bf16 and f32 eager bag steps in
    turns; the bf16 step's working set per instance; a bf16 store."""
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.train.trainer import BagTrainer

    dev = torch.device("cuda")
    cfgs = {torch.float32: DSMILConfig(K, C),
            torch.bfloat16: DSMILConfig(K, C, compute_dtype=torch.bfloat16)}
    trainer = BagTrainer(cfgs[torch.bfloat16], weight_decay=1e-3,
                         fused_threshold=16384, device=dev)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    kernels = (ap.attention_pool_fwd, ap.attention_pool_bwd1,
               ap.attention_pool_bwd2)
    for fn in kernels:  # the bf16 run starts here
        fn.launches = 0
    t0 = time.perf_counter()
    losses, scores = [], None
    for epoch in range(TRAIN_EPOCHS):
        model, opt, loss = trainer.train_epoch(model, opt, store,
                                               1e-4 / (epoch + 1), rng)
        scores, _ = trainer.predict(model, store, rng=rng)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = [fn.launches for fn in kernels]
    np.testing.assert_allclose(losses, eager_losses, rtol=2e-2)
    if losses == list(eager_losses):
        raise AssertionError("the bf16 losses equal the f32 losses: the "
                             "compute dtype did not flow")
    if trainer.fused_dispatches or any(launched):
        raise AssertionError(f"the bf16 config reached the kernels: "
                             f"{trainer.fused_dispatches} dispatches, "
                             f"K1/K2/K3 launches {launched}")
    if scores.shape != (store.num_bags, C) or not np.isfinite(scores).all():
        raise AssertionError(f"bad bf16 scores {scores.shape}")
    bf_model = model
    params = {p.dtype for p in model.parameters()}
    moments = {t.dtype for st in opt.state.values() for t in st.values()
               if t.dim() > 0}
    if params != {torch.float32} or moments != {torch.float32}:
        raise AssertionError(f"bf16 training left f32: params {params}, "
                             f"Adam {moments}")
    gap = float(np.max(np.abs(np.asarray(losses) - eager_losses)
                       / np.abs(eager_losses)))
    log(f"[train] bf16 compute (fused_threshold=16384): {TRAIN_EPOCHS} "
        f"epochs x {store.num_bags} bags + predict in {wall:.2f} s; losses "
        f"{[f'{x:.6f}' for x in losses]} against the f32 eager route's "
        f"{[f'{x:.6f}' for x in eager_losses]} (max relative gap {gap:.3e}, "
        f"bar 2e-2, not equal); fused dispatches 0, K1/K2/K3 launches "
        f"{launched}; parameters and Adam's moments f32; {gpu}")

    # one eager bag step in each dtype, in turns (f32, bf16, bf16, f32), from
    # the same init
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (4000, 65529):
        feats, label = store.bag(TRAIN_N.index(n)), store.label(
            TRAIN_N.index(n))
        runs = {}
        for dt, cfg in cfgs.items():
            tr = BagTrainer(cfg, weight_decay=1e-3, fused_threshold=None,
                            device=dev)
            runs[dt] = (tr, *tr.init(torch.Generator().manual_seed(0)))
        order = (torch.float32, torch.bfloat16, torch.bfloat16,
                 torch.float32)
        ms = {dt: [] for dt in cfgs}
        for dt in order:
            ms[dt].append(step_ms(*runs[dt], feats, label, False))
        dev_ms = {dt: step_device_ms(*runs[dt], feats, label) for dt in cfgs}
        busy = ", ".join(
            f"{'f32' if dt == torch.float32 else 'bf16'} "
            + ("not measured" if v is None else f"{v:.3f} ms")
            for dt, v in dev_ms.items())
        log(f"[train] one eager bag step at N={n}, K={K}, C={C} (host "
            f"clock, synced, mean of 5, in turns f32/bf16/bf16/f32): f32 "
            f"{ms[torch.float32][0]:.3f} / {ms[torch.float32][1]:.3f} ms, "
            f"bf16 {ms[torch.bfloat16][0]:.3f} / {ms[torch.bfloat16][1]:.3f}"
            f" ms; device busy per step (torch.profiler, 5 steps): {busy}; "
            f"{gpu}")
    tr, model, opt = runs[torch.bfloat16]
    sizes = (16384, 65529)
    peak = [peak_bytes(lambda: tr._train_bags(
        model, opt, [(store.feats[:n], label)], False, gen)) for n in sizes]
    log(f"[train] bf16 eager step peak bytes above residents at N={sizes}: "
        f"{peak}; per instance {(peak[1] - peak[0]) / (sizes[1] - sizes[0]):.0f}"
        f" B (slope; K={K}); {gpu}")

    half = DeviceBagStore(synthetic_bags(TRAIN_N, 3), device=dev,
                          dtype=torch.bfloat16)
    if half.feats.dtype != torch.bfloat16 \
            or 2 * half.feats.nbytes != store.feats.nbytes:
        raise AssertionError(f"bf16 store: {half.feats.dtype}, "
                             f"{half.feats.nbytes} B of features")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = trainer.predict(bf_model, half)
    wall = time.perf_counter() - t0
    want, _ = trainer.predict(bf_model, store)
    np.testing.assert_array_equal(got, want)
    log(f"[train] bf16 DeviceBagStore: nbytes {half.nbytes()} against the "
        f"f32 store's {store.nbytes()} ({half.nbytes() / store.nbytes():.4f})"
        f"; the bf16 trainer's predict on it in {wall:.3f} s, scores "
        f"bitwise its predict on the f32 store; {gpu}")


def phase_train_wsi() -> dict:
    """The CLI a user runs, as a subprocess on a synthetic TCGA-shaped
    dataset in a temporary directory, which [scale_out] trains again and
    then removes."""
    from tpumil_torch.data.feature_store import write_bag_csv
    from tpumil_torch.io import torch_ckpt

    rng = np.random.default_rng(4)
    sizes = rng.integers(200, 3001, 30).tolist()
    bags = synthetic_bags(sizes, 5)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wsi_")
    root = os.path.join(tmp, "datasets", "synth")
    rows = []
    for i, bag in enumerate(bags):
        cls = int(np.argmax(bag.label))
        path = os.path.join(root, f"class{cls}", f"bag{i}.csv")
        write_bag_csv(bag.feats, path)
        rows.append(f"{path},{cls}")
    with open(os.path.join(root, "synth.csv"), "w") as f:
        f.write("0,label\n" + "\n".join(rows) + "\n")
    cmd = [sys.executable, "-m", "tpumil_torch.cli.train_wsi",
           "--device", "cuda", "--dataset", "synth", "--num_classes",
           str(C), "--feats_size", str(K), "--num_epochs", "2",
           "--eval_scheme", "5-fold-cv"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"train_wsi exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    save = os.path.join(tmp, "weights")
    (day,) = os.listdir(save)
    save = os.path.join(save, day)
    for ext in (".pth", ".json", ".done.json"):
        found = [f for f in os.listdir(save)
                 if f.startswith("fold_") and f.endswith(ext)
                 and (ext == ".done.json" or not f.endswith(".done.json"))]
        if len(found) != 5:
            raise AssertionError(f"expected 5 fold_*{ext}, found {found}")
    model, cfg, _ = torch_ckpt.load_mil_pth(os.path.join(save, "fold_0.pth"),
                                            torch.device("cuda"))
    with torch.inference_mode():
        _, bag_logits, _, _ = model(torch.from_numpy(bags[0].feats).cuda())
    if cfg.feats_size != K or cfg.num_classes != C \
            or not torch.isfinite(bag_logits).all():
        raise AssertionError(f"fold_0.pth: bad model {cfg}")
    final = [l for l in proc.stdout.splitlines() if "Mean" in l]
    log(f"[train_wsi] {' '.join(cmd[1:])}: exit 0 in {wall:.2f} s on "
        f"{len(bags)} bags of 200-3000 x {K}; 5 fold_*.pth/.json/.done.json;"
        f" fold_0.pth loads on the card; {'; '.join(final)}")
    return {"tmp": tmp, "cmd": cmd, "save": save, "wall": wall}


MIL_MODELS = ("dsmil", "abmil", "meanpool", "maxpool")
MUSK = os.path.join(REPO, "tests", "data", "musk1_mini.svm")


def mil_step_ms(model: str, store, dev, epochs: int = 3) -> float:
    """Host-clock ms of one bag step of ``model`` over the store's bags
    (the default "auto" route), after a warm-up epoch, synced."""
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    trainer = BagTrainer(DSMILConfig(store.feats.shape[1], 1),
                         weight_decay=5e-3, model=model, device=dev)
    net, opt = trainer.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    trainer.train_epoch(net, opt, store, 2e-4, rng, shuffle=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        trainer.train_epoch(net, opt, store, 2e-4, rng, shuffle=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (epochs * store.num_bags)


def phase_train_mil(gpu: str) -> None:
    """The classic-MIL benchmark path on musk1_mini (30 bags of 4-17
    instances, K = 166, C = 1, 3 folds x 2 epochs): train_mil as a
    subprocess for dsmil, run_mil_cv in-process for the other models, ms
    per bag step of each; then the kernel route at K = 166 against the
    eager route on the same bags."""
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.data.mil_bench import parse_mil_file
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.train import schemes
    from tpumil_torch.train.trainer import BagTrainer

    dev = torch.device("cuda")
    bags = parse_mil_file(MUSK, 166)
    store = DeviceBagStore(bags, device=dev)
    args = ["--data_file", MUSK, "--num_feats", "166", "--cv_fold", "3",
            "--num_epoch", "2"]
    for model in MIL_MODELS:
        t0 = time.perf_counter()
        if model == "dsmil":  # the CLI a user runs, on the default device
            with tempfile.TemporaryDirectory() as tmp:
                proc = subprocess.run(
                    [sys.executable, "-m", "tpumil_torch.cli.train_mil", *args,
                     "--model", model], cwd=tmp, capture_output=True,
                    text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
            if proc.returncode != 0 or "device: cuda" not in proc.stdout:
                raise RuntimeError(f"train_mil exited {proc.returncode}:\n"
                                   f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            lines = proc.stdout.splitlines()
            how = "python -m tpumil_torch.cli.train_mil " + " ".join(args)
        else:
            lines = []
            schemes.run_mil_cv(bags, schemes.MILBenchConfig(
                num_feats=166, cv_fold=3, num_epochs=2, model=model,
                device=dev), log=lines.append)
            torch.cuda.synchronize()
            how = "run_mil_cv in-process"
        wall = time.perf_counter() - t0
        accs = [float(l.rsplit(" ", 1)[1]) for l in lines
                if "optimal accuracy" in l]
        if len(accs) != 3 or not all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"{model}: fold accuracies {accs}")
        log(f"[train_mil] {model}: {how}: fold accuracies {accs} in "
            f"{wall:.2f} s wall; {mil_step_ms(model, store, dev):.3f} ms per "
            f"bag step (auto route, host clock, mean of 3 epochs x "
            f"{store.num_bags} bags); {gpu}")

    # the kernel route at K = 166, C = 1 against the eager route
    misaligned = sum(store.bag(i).data_ptr() % 16 != 0
                     for i in range(store.num_bags))
    kernels = (ap.attention_pool_fwd, ap.attention_pool_bwd1,
               ap.attention_pool_bwd2)
    runs = {}
    for route, thr in (("kernel", 0), ("eager", None)):
        trainer = BagTrainer(DSMILConfig(166, 1), weight_decay=5e-3,
                             fused_threshold=thr, device=dev)
        trainer.pos_weight = np.asarray([1.0], np.float32)
        net, opt = trainer.init(torch.Generator().manual_seed(0))
        for fn in kernels:  # the route starts here
            fn.launches = 0
        _, _, loss = trainer.train_epoch(net, opt, store, 2e-4,
                                         np.random.default_rng(0),
                                         shuffle=False)
        scores, _ = trainer.predict(net, store)
        torch.cuda.synchronize()
        runs[route] = (loss, {k: v.cpu() for k, v in net.state_dict().items()},
                       scores, [fn.launches for fn in kernels],
                       trainer.fused_dispatches)
    (l_k, p_k, s_k, n_k, d_k), (l_e, p_e, s_e, n_e, _) = runs["kernel"], \
        runs["eager"]
    np.testing.assert_allclose(l_k, l_e, rtol=2e-4)
    for name in p_k:
        np.testing.assert_allclose(p_k[name].numpy(), p_e[name].numpy(),
                                   rtol=1e-3, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(s_k, s_e, rtol=0, atol=1e-4)
    if min(n_k) == 0 or max(n_e) != 0 or not np.isfinite(s_k).all():
        raise AssertionError(f"K1/K2/K3 launches: kernel route {n_k}, eager "
                             f"route {n_e}")
    log(f"[train_mil] BagTrainer(DSMILConfig(166, 1), fused_threshold=0) vs "
        f"fused_threshold=None, one epoch over {store.num_bags} musk bags "
        f"({misaligned} views off a 16-byte boundary): losses {l_k:.6f} / "
        f"{l_e:.6f} (rtol 2e-4), params rtol 1e-3 atol 2e-5, scores atol "
        f"1e-4 -- all hold; max |d score| {np.abs(s_k - s_e).max():.3e}; "
        f"{d_k} fused dispatches; K1/K2/K3 launches {n_k}")


def stem_inputs(b: int, seed: int):
    """[0, 1) images and kaiming-scaled HWIO stem weights on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((b, 224, 224, 3), np.float32)).cuda()
    w = rng.standard_normal((7, 7, 3, 64)) * np.sqrt(2.0 / (7 * 7 * 64))
    return x, torch.from_numpy(w.astype(np.float32)).cuda()


def stem_err(name: str, x, w7, got, want, dtype) -> float:
    """|kernel - plain| within the bar. f32: atol = rtol = 1e-4
    (test_stem_pallas.py's bar; sums in another order). bf16: one bf16 step
    of the conv output in normalized units (|x| * inv <= |out| + |mean| *
    inv per (image, channel); a pool window's maximum moves by at most that
    step) plus one bf16 step of the output."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    if dtype == torch.float32:
        bar = 1e-4 + 1e-4 * want.abs()
    else:
        conv = F.conv2d(x.permute(0, 3, 1, 2).to(dtype),
                        w7.permute(3, 2, 0, 1).to(dtype), stride=2,
                        padding=3).float()
        inv = torch.rsqrt(conv.var(dim=(2, 3), unbiased=False) + 1e-5)
        shift = (conv.mean(dim=(2, 3)).abs() * inv)[:, None, None, :]
        bar = 2 ** -7 * (2 * want.abs() + shift) + 1e-6
    bad = err > bar
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of the "
                             f"bar (max abs err {err.max().item():.3e})")
    return err.max().item()


def phase_stem(gpu: str) -> dict:
    """K5 against its plain version at the compute_feats batch; times of the
    kernel, the plain version and the conv route (cuDNN conv, K4, max
    pool). The f32 bound counts the conv's products as 3xTF32 on the tensor
    cores (three TF32 products per f32 product), the f32 FFMA bound
    beside."""
    from tpumil_torch.ops.stem import fused_stem, stem_plain
    from tpumil_torch.utils.device import disable_tf32

    disable_tf32()
    x, w7 = stem_inputs(B, 5)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        got = fused_stem(x, w7, dtype)
        torch.cuda.synchronize()
        want = stem_plain(x, w7, dtype)
        err = stem_err(f"K5 {name}", x, w7, got, want, dtype)
        if not torch.equal(fused_stem(x, w7, dtype), got):
            raise AssertionError(f"K5 {name}: a rerun is not bitwise equal")
        del want
        ms = cuda_ms(lambda: fused_stem(x, w7, dtype), 20)
        plain_ms = cuda_ms(lambda: stem_plain(x, w7, dtype), 10)
        route_ms = cuda_ms(lambda: conv_route_stem(x, w7, dtype), 20)
        ms2 = cuda_ms(lambda: fused_stem(x, w7, dtype), 20)
        flops = 2 * B * 112 * 112 * 64 * 7 * 7 * 3  # the conv; the rest < 1%
        io = nbytes(x, w7, got)
        bound_ms, bound_by = bound(io, flops, dtype)
        ffma = ""
        if dtype == torch.float32:
            # the f32 products run as 3xTF32: three TF32 products each
            ffma = f"; at f32 FFMA rates {bound_ms:.4f} ms"
            t_ops, t_bytes = 3 * flops / TF32_FLOPS, io / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
        out[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[stem] K5 {name} [{B},224,224,3] f32 in -> [{B},56,56,64] "
            f"{name}: max_abs_err {err:.3e}, rerun bitwise equal; kernel "
            f"{ms:.4f} / {ms2:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, conv route (cuDNN conv + K4 + max pool) "
            f"{route_ms:.4f} ms (the earlier FFMA design: "
            f"{K5_FFMA_MS[dtype]} ms); bound {bound_ms:.4f} ms ({bound_by}"
            f"{', 3xTF32' if ffma else ''}: {flops} flop, {io} B){ffma}; "
            f"{gpu}")
        del got
    torch.cuda.empty_cache()
    # blank tissue: black (a constant conv plane: exact zeros), white (not
    # constant: the zero padding reaches the border), near-white,
    # near-black; and a tile-boundary image: bright input rows and columns
    # that, in a pooled window, reach the conv row (column) that the
    # previous tile (column tile) of the kernel computes first
    noise = torch.from_numpy(np.random.default_rng(6).integers(
        0, 3, (1, 224, 224, 3)).astype(np.float32) / 255).cuda()
    edge = noise.clone()
    edge[:, [2 * r0 - 5 for r0 in range(8, 112, 8)]] = 1.0
    edge[:, :, [2 * c0 - 5 for c0 in range(16, 112, 16)]] = 1.0
    blank = torch.cat([torch.zeros_like(noise), torch.ones_like(noise),
                       1 - noise, noise, edge])
    for dtype in (torch.float32, torch.bfloat16):
        got = fused_stem(blank, w7, dtype)
        torch.cuda.synchronize()
        if not torch.equal(got[0], torch.zeros_like(got[0])):
            raise AssertionError("K5: a black image must give exact zeros")
        want = stem_plain(blank, w7, dtype)
        err = stem_err(f"K5 blank {dtype}", blank[:4], w7, got[:4], want[:4],
                       dtype)
        err_edge = stem_err(f"K5 tile boundary {dtype}", blank[4:], w7,
                            got[4:], want[4:], dtype)
        log(f"[stem] {str(dtype)[6:]} black -> exact zeros; white, "
            f"near-white, near-black max_abs_err {err:.3e}; tile-boundary "
            f"image max_abs_err {err_edge:.3e}")
    return out


def run_cli(module: str, args, cwd: str) -> str:
    cmd = [sys.executable, "-m", module, *args]
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def phase_compute_feats(gpu: str):
    """The feature-extraction path: the CLI a user runs, then the same
    extraction in-process, its stem in K5, against the same net with the
    conv-route stem, then train_wsi on the CSVs the CLI wrote. Returns the
    K5 launch count, and the directory (and the CLI's wall) that
    [scale_out_embed] runs the CLI in again; the caller removes it."""
    from tpumil_torch.data.feature_store import read_bag_csv, read_master_csv
    from tpumil_torch.data.patches import (PatchBatchLoader, list_bag_dirs,
                                           list_patches)
    from tpumil_torch.infer.features import (ExtractorStats, FeatureExtractor,
                                             compute_feats)
    from tpumil_torch.models import embedder, resnet
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem
    from tools.extract_profile import write_tree

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cf_")
    write_tree(os.path.join(tmp, "WSI"), CF_CLASSES * CF_BAGS, CF_PATCHES,
               224, 7)
    n = CF_CLASSES * CF_BAGS * CF_PATCHES
    model = embedder.init_params(0, embedder.EmbedderConfig(),
                                 torch.device("cpu"))
    torch.save(embedder.export_embedder_state_dict(model),
               os.path.join(tmp, "model.pth"))
    t0 = time.perf_counter()
    out = run_cli("tpumil_torch.cli.compute_feats",
                  ["--device", "cuda", "--dataset", "synth", "--weights",
                   "model.pth", "--num_classes", str(C)], tmp)
    wall = time.perf_counter() - t0
    (throughput,) = [l for l in out.splitlines()
                     if l.startswith("Throughput")]
    log(f"[compute_feats] python -m tpumil_torch.cli.compute_feats "
        f"--device cuda (f32, batch {B}) on {n} patches of 224^2: exit 0 "
        f"in {wall:.2f} s; {throughput}; {gpu}")

    # in-process, from the embedder the CLI exported, in the CLI's
    # configuration; in turns the stem in K5 (the path whose launches
    # are counted: the first K5 run) and in the conv route
    bag_dirs = list_bag_dirs(os.path.join(tmp, "WSI"), "synth", "single")
    paths = [p for d in bag_dirs for p in list_patches(d)]
    ckpt = os.path.join(tmp, "embedder", "synth", "embedder.pth")
    ex = FeatureExtractor(embedder.load_simclr_checkpoint(
        ckpt, embedder.EmbedderConfig(space_to_depth=True), dev), B, 224, 8)

    def on(route, fn):
        """fn() with the stem in K5 or in the conv route."""
        if route == "conv":
            resnet.fused_stem = conv_route_stem
        try:
            return fn()
        finally:
            resnet.fused_stem = fused_stem

    counts, rates = {}, {}
    for route in ("k5", "conv", "conv", "k5"):
        ex.stats = ExtractorStats()
        fused_stem.launches = fused_instance_norm.launches = 0
        on(route, lambda: compute_feats(bag_dirs, ex,
                                        os.path.join(tmp, route)))
        torch.cuda.synchronize()
        counts.setdefault(route, (fused_stem.launches,
                                  fused_instance_norm.launches))
        rates.setdefault(route, []).append(ex.stats.patches_per_sec)
    feats = {route: on(route, lambda: ex.embed_paths(paths))
             for route in ("k5", "conv")}
    names = {"k5": "K5 stem (the path)", "conv": "conv-route stem"}
    for route in ("k5", "conv"):
        log(f"[compute_feats] in-process compute_feats, {names[route]}: "
            f"{' / '.join(f'{r:.1f}' for r in rates[route])} patches/s "
            f"over {n} patches; K5/K4 launches {counts[route]}; {gpu}")
    # the host decode alone, as the extractor's loader runs it
    t0 = time.perf_counter()
    for _ in PatchBatchLoader(paths, B, 224, 8):
        pass
    log(f"[compute_feats] host JPEG decode alone (8 threads, batch {B}): "
        f"{n / (time.perf_counter() - t0):.1f} patches/s on "
        f"{os.cpu_count()} cores")
    k5, k4 = counts["k5"]
    if k5 == 0 or k4 == 0 or counts["conv"][0] != 0:
        raise AssertionError(f"K5/K4 launches: the path {counts['k5']}, "
                             f"the conv route {counts['conv']}")
    got, want = feats["k5"], feats["conv"]
    if got.shape != (n, 512) or not np.isfinite(got).all():
        raise AssertionError(f"bad features {got.shape}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the CLI's CSVs against the in-process path's: %.4f text, so one
    # last-digit flip on top of the 1e-4 bar
    csv_err = 0.0
    for d in bag_dirs:
        rel = os.path.join(*d.split(os.path.sep)[-2:]) + ".csv"
        a = read_bag_csv(os.path.join(tmp, "datasets", "synth", rel))
        b = read_bag_csv(os.path.join(tmp, "k5", rel))
        np.testing.assert_allclose(b, a, rtol=0, atol=1.5e-4)
        csv_err = max(csv_err, float(np.abs(a - b).max()))
    master = read_master_csv(os.path.join(tmp, "datasets", "synth",
                                          "synth.csv"))
    if len(master) != CF_CLASSES * CF_BAGS:
        raise AssertionError(f"master CSV has {len(master)} rows")
    log(f"[compute_feats] K5 stem vs conv-route stem features: max_abs_err "
        f"{np.abs(got - want).max():.3e} (atol 1e-4, rtol 1e-4); the "
        f"CLI's CSVs vs the in-process path's {csv_err:.1e} (atol "
        f"1.5e-4); master CSV {len(master)} bags")

    t0 = time.perf_counter()
    out = run_cli("tpumil_torch.cli.train_wsi",
                  ["--device", "cuda", "--dataset", "synth",
                   "--num_classes", str(C), "--feats_size", "512",
                   "--num_epochs", "1"], tmp)
    final = [l for l in out.splitlines() if "Mean" in l]
    if not final:
        raise AssertionError("train_wsi printed no final results")
    log(f"[compute_feats] train_wsi --device cuda --num_epochs 1 on the "
        f"CSVs: exit 0 in {time.perf_counter() - t0:.2f} s; "
        f"{'; '.join(final)}")
    return k5, {"tmp": tmp, "cli_wall": wall}


def pipeline_slides(root: str, seed: int) -> int:
    """PL_CLASSES x PL_SLIDES two-page TIFFs under root/WSI/demo/<class>/;
    returns the slide count."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    t = PL_TISSUE
    for cls in ("tumor", "normal")[:PL_CLASSES]:
        d = os.path.join(root, "WSI", "demo", cls)
        os.makedirs(d)
        for i in range(PL_SLIDES):
            img = np.full((PL_SIDE, PL_SIDE, 3), 255, np.uint8)
            if cls == "tumor":
                img[:t, :t] = (rng.random((t, t, 3)) * 180 + 20).astype(np.uint8)
            else:
                tex = rng.random((t, t, 3)) * 60 + 120
                tex[..., 1] += 40
                img[:t, :t] = np.clip(tex, 0, 255).astype(np.uint8)
            page = Image.fromarray(img)
            page.save(os.path.join(d, f"{cls}{i}.tif"), save_all=True,
                      append_images=[page.resize((PL_SIDE // 2,) * 2)],
                      description="|AppMag = 20|")
    return PL_CLASSES * PL_SLIDES


def phase_pipeline(gpu: str) -> dict:
    """The five-stage pipeline on the card at the embedder's full width
    (ResNet18-IN, 224^2 tiles, 512 features): python -m
    tpumil_torch.cli.pipeline --stages tile,simclr as a subprocess, then
    pipeline.main for feats, train and maps one at a time, with the kernel
    launches of each stage counted; every stage's artifacts, the resolved
    YAML's round trip, each stage's wall."""
    from tpumil_torch.cli import pipeline
    from tpumil_torch.data.feature_store import read_bag_csv, read_master_csv
    from tpumil_torch.io.config import PipelineConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem

    kernels = {"K5": fused_stem, "K4": fused_instance_norm,
               "K1": ap.attention_pool_fwd, "K2": ap.attention_pool_bwd1,
               "K3": ap.attention_pool_bwd2}
    walls, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        slides = pipeline_slides(tmp, 11)
        with open(os.path.join(tmp, "exp.yaml"), "w") as f:
            f.write("dataset: demo\n"
                    "magnifications: [0]\n"
                    "tiler:\n  tile_size: 224\n"
                    "simclr:\n  batch_size: 32\n  epochs: 1\n"
                    "embedder:\n  num_classes: 1\n  batch_size: 64\n"
                    "  precision: f32\n"
                    "train:\n  num_classes: 1\n  feats_size: 512\n"
                    "  num_epochs: 3\n  stop_epochs: 2\n  lr: 0.002\n"
                    "  verbose: false\n"
                    "inference:\n  thresholds: [0.0]\n")
        t0 = time.perf_counter()
        out = run_cli("tpumil_torch.cli.pipeline",
                      ["--config", "exp.yaml", "--stages", "tile,simclr"], tmp)
        walls["tile+simclr (CLI)"] = time.perf_counter() - t0
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for stage in ("feats", "train", "maps"):
                for fn in kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                if pipeline.main(["--config", "exp.yaml", "--stages",
                                  stage]) != 0:
                    raise AssertionError(f"pipeline stage {stage} failed")
                torch.cuda.synchronize()
                walls[stage] = time.perf_counter() - t0
                counts[stage] = {k: fn.launches for k, fn in kernels.items()}
        finally:
            os.chdir(cwd)
        tiles = [os.path.join(r, x) for r, _, fs in
                 os.walk(os.path.join(tmp, "WSI", "demo", "single"))
                 for x in fs if x.endswith(".jpeg")]
        bags = read_master_csv(os.path.join(tmp, "datasets", "demo",
                                            "demo.csv"))
        feats = [read_bag_csv(os.path.join(tmp, p)) for p, _ in bags]
        run = os.path.join(tmp, "runs", "demo")
        folds = [x for x in os.listdir(os.path.join(run, "weights"))
                 if x.startswith("fold_") and x.endswith(".pth")]
        maps = [x for x in os.listdir(os.path.join(run, "maps"))
                if x.endswith(".png")]
        resolved = os.path.join(run, "resolved_config.yaml")
        same = PipelineConfig.from_yaml(resolved).to_dict() == \
            PipelineConfig.from_yaml(os.path.join(tmp, "exp.yaml")).to_dict()
        checks = {
            "tiles": len(tiles) >= 2 * slides,
            "simclr model.pth": os.path.exists(os.path.join(
                run, "simclr", "checkpoints", "model.pth")),
            "a bag CSV per slide, 512 finite features": len(bags) == slides
            and all(x.shape[1] == 512 and np.isfinite(x).all()
                    for x in feats),
            "5 fold_*.pth": len(folds) == 5,
            "a map per slide": len(maps) == slides,
            "resolved_config.yaml round-trips": same,
            "K5 and K4 in feats and maps": all(
                counts[st]["K5"] > 0 and counts[st]["K4"] > 0
                for st in ("feats", "maps")),
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"pipeline: {failed}; launches {counts}; "
                                 f"{out[-2000:]}")
        log(f"[pipeline] python -m tpumil_torch.cli.pipeline on {slides} "
            f"slides of {PL_SIDE}^2 (ResNet18-IN f32, 224^2 tiles, SimCLR 1 "
            f"epoch at batch 32, 5-fold-cv-standalone-test 3 epochs): "
            f"{len(tiles)} tiles, {len(bags)} bags of "
            f"{min(len(x) for x in feats)}-{max(len(x) for x in feats)} x "
            f"512, {len(folds)} folds, {len(maps)} maps; "
            + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
            + "; launches "
            + "; ".join(f"{st}: " + " ".join(f"{k} {v}" for k, v in c.items())
                        for st, c in counts.items())
            + f"; {', '.join(checks)}: ok; {gpu}")
    return {"walls": walls, "counts": counts}


def read_pos_csv(path: str):
    rows = np.loadtxt(path, dtype=int, delimiter=",", skiprows=1, ndmin=2)
    return {(int(c), int(r)) for c, r in rows}


def phase_slide_feats(gpu: str) -> None:
    """The slide front end: the tiler and slide_feats CLIs a user runs on
    the same slides, then the stream in-process with K5/K4 launches
    counted and its features held against direct embedding."""
    from torch.profiler import ProfilerActivity, profile

    from tpumil_torch.data.feature_store import read_bag_csv, read_master_csv
    from tpumil_torch.data.patches import list_patches, parse_position
    from tpumil_torch.data.slide import DeepZoom, magnification_plan, open_slide
    from tpumil_torch.data.tiler import TilerConfig
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.stream_embed import embed_slide_streaming
    from tpumil_torch.models import embedder
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem
    from tpumil_torch.utils import native
    from tools.serve_profile import busy_us, device_events
    from tools.stream_profile import synth_slide, write_slide

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        slides = []
        for c in range(SF_CLASSES):
            path = os.path.join(tmp, "WSI", "sf", f"class{c}", f"slide{c}.tif")
            write_slide(path, synth_slide(SF_SIDE, SF_TISSUE, 11 + c),
                        tiled=False)
            slides.append(path)
        reader = type(open_slide(slides[0])).__name__
        edge = "native" if native.available() else "PIL"
        model = embedder.init_params(0, embedder.EmbedderConfig(),
                                     torch.device("cpu"))
        torch.save(embedder.export_embedder_state_dict(model),
                   os.path.join(tmp, "model.pth"))

        t0 = time.perf_counter()
        run_cli("tpumil_torch.cli.tiler", ["-d", "sf", "-v", "tif"], tmp)
        tiler_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run_cli("tpumil_torch.cli.slide_feats",
                      ["--device", "cuda", "--dataset", "sf",
                       "--slide_format", "tif", "--weights", "model.pth"], tmp)
        cli_wall = time.perf_counter() - t0
        feats_root = os.path.join(tmp, "datasets", "sf")
        master = read_master_csv(os.path.join(feats_root, "sf.csv"))
        if len(master) != SF_CLASSES:
            raise AssertionError(f"master CSV has {len(master)} rows")
        n_total, kept = 0, []
        for c, path in enumerate(slides):
            bag = os.path.join(f"class{c}", f"slide{c}")
            folder = {parse_position(p) for p in list_patches(
                os.path.join(tmp, "WSI", "sf", "single", bag))}
            streamed = read_pos_csv(os.path.join(feats_root, bag + ".pos.csv"))
            csv = read_bag_csv(os.path.join(feats_root, bag + ".csv"))
            if streamed != folder or csv.shape != (len(folder), 512):
                raise AssertionError(
                    f"{bag}: the tiler kept {len(folder)} tiles, the stream "
                    f"{len(streamed)} ({len(folder ^ streamed)} differ), CSV "
                    f"{csv.shape}")
            n_total += (SF_SIDE // 224) ** 2
            kept.append(len(folder))
        log(f"[slide_feats] {SF_CLASSES} slides {SF_SIDE}^2 at 20x, "
            f"{(SF_SIDE // 224) ** 2} tiles of 224^2 each, reader {reader}, "
            f"edge filter {edge}: python -m tpumil_torch.cli.tiler exit 0 in "
            f"{tiler_wall:.2f} s ({n_total / tiler_wall:.1f} tiles/s); python "
            f"-m tpumil_torch.cli.slide_feats --device cuda (f32, batch {B}) "
            f"exit 0 in {cli_wall:.2f} s = {n_total / cli_wall:.1f} tiles/s, "
            f"{SF_CLASSES * 60.0 / cli_wall:.3f} slides/min, start-up "
            f"included; kept {kept} tiles, the same set as the tiler's "
            f"folders per slide; {gpu}")

        # in-process, from the CLI's embedder and configuration
        ex = FeatureExtractor(embedder.load_simclr_checkpoint(
            os.path.join(tmp, "model.pth"),
            embedder.EmbedderConfig(num_classes=1, space_to_depth=True), dev),
            B, 224)
        ex.embed_arrays(np.zeros((B, 224, 224, 3), np.uint8))  # warm-up
        cfg = TilerConfig()
        torch.cuda.synchronize()
        fused_stem.launches = fused_instance_norm.launches = 0
        t0 = time.perf_counter()
        feats, pos, stats = embed_slide_streaming(slides[0], ex, (0,), cfg, B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k4 = fused_stem.launches, fused_instance_norm.launches
        batches = -(-stats.tiles_kept // B)
        if stats.tiles_kept % B == 0 or (k5, k4) != (batches, 19 * batches):
            raise AssertionError(f"{stats.tiles_kept} tiles kept in {batches} "
                                 f"batches: K5/K4 launches {(k5, k4)}, want "
                                 f"{(batches, 19 * batches)}, a padded batch")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            embed_slide_streaming(slides[0], ex, (0,), cfg, B)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        events = device_events(prof)
        busy = (f"{busy_us(events) / 1e6 / traced * 100:.1f}% of the traced "
                f"wall {traced:.3f} s" if events else "not measured (no "
                "device events in the trace)")

        # the same tiles read back, embedded directly in batches of B
        slide = open_slide(slides[0])
        dz = DeepZoom(slide, cfg.tile_size)
        (level, _), = magnification_plan(dz, (0,), cfg.base_mag,
                                         cfg.objective)
        tiles = np.stack([dz.get_tile(level, tuple(p)) for p in pos])
        slide.close()
        n = len(tiles)
        tiles = np.concatenate([tiles, np.zeros((batches * B - n, 224, 224, 3),
                                                np.uint8)])
        direct = np.concatenate([ex.embed_arrays(tiles[i:i + B])
                                 for i in range(0, len(tiles), B)])
        if not np.isfinite(direct).all() or np.any(direct[n:] != 0):
            raise AssertionError("zero padding tiles gave non-zero features")
        if feats.shape != (n, 512) or not np.isfinite(feats).all():
            raise AssertionError(f"bad streamed features {feats.shape}")
        np.testing.assert_allclose(feats, direct[:n], rtol=1e-4, atol=1e-4)
        csv = read_bag_csv(os.path.join(feats_root, "class0", "slide0.csv"))
        np.testing.assert_allclose(csv, feats, rtol=0, atol=1.5e-4)
        log(f"[slide_feats] in-process embed_slide_streaming (f32, batch "
            f"{B}, {cfg.workers} fetch threads): {stats.tiles_kept}/"
            f"{stats.tiles_total} tiles kept in {batches} batches (the last "
            f"padded by {batches * B - n}), K5/K4 launches {k5}/{k4} (1/19 "
            f"per batch); {wall:.3f} s = {stats.tiles_total / wall:.1f} "
            f"tiles/s, {60.0 / wall:.3f} slides/min; device busy {busy}; "
            f"producer: reads {stats.fetch_seconds:.3f} s over the threads, "
            f"filter {stats.filter_seconds:.3f} s, resize "
            f"{stats.resize_seconds:.3f} s; {gpu}")
        log(f"[slide_feats] streamed vs embed_arrays of the tiles read back "
            f"(padded batch included): max_abs_err "
            f"{np.abs(feats - direct[:n]).max():.3e} (atol 1e-4, rtol 1e-4); "
            f"the CLI's CSV vs in-process {np.abs(csv - feats).max():.1e} "
            f"(atol 1.5e-4); padding rows exactly 0")


def verdicts(out: str):
    return [l.split(" is detected as")[1] for l in out.splitlines()
            if " is detected as" in l]


def phase_attention_map(gpu: str) -> None:
    """The inference-and-heatmap path: the three CLIs a user runs on the
    card, then run_attention_maps in-process with K5/K4 launches counted,
    held against embed_paths plus the aggregator and the CPU path."""
    from torch.profiler import ProfilerActivity, profile

    from tpumil_torch.cli.attention_map import load_milnet
    from tpumil_torch.data.patches import list_patches
    from tpumil_torch.infer.heatmap import (BagInference, HeatmapStats,
                                            run_attention_maps)
    from tpumil_torch.models import embedder
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem
    from tools.heatmap_profile import CLASSES, THRESHOLDS, write_bag
    from tools.serve_profile import busy_us, device_events

    dev = torch.device("cuda")
    tcga = os.path.join(REPO, "tests", "data", "tcga_aggregator.pth")
    c16 = os.path.join(REPO, "tests", "data", "c16_aggregator.pth")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "patches")
        bags = [os.path.join(root, f"slide{i}") for i in range(len(AM_BAGS))]
        sides = [write_bag(d, n, 224, 20 + i, holes=True)
                 for i, (d, n) in enumerate(zip(bags, AM_BAGS))]
        src = embedder.init_params(0, embedder.EmbedderConfig(),
                                   torch.device("cpu"))
        emb_path = os.path.join(tmp, "embedder.pth")
        torch.save(embedder.export_embedder_state_dict(src), emb_path)
        n_total = sum(AM_BAGS)

        common = ["--device", "cuda", "--embedder_weights", emb_path,
                  "--bag_path", root]
        am = ["--aggregator_weights", tcga, "--thres", *map(str, THRESHOLDS),
              "--class_name", *CLASSES, "--export_scores", "1", "--seed", "0"]
        # each run: the CLI (and its extra flags), its arguments, the folders
        # it must fill, one file per bag
        runs = {
            "attention_map": (am + ["--map_path", "am", "--score_path",
                                    "am_scores"], ("am", "am_scores")),
            "testing_tcga": (["--aggregator_weights", tcga, "--output",
                              "tcga"], ("tcga",)),
            "testing_c16": (["--aggregator_weights", c16, "--output", "c16"],
                            ("c16",)),
            "attention_map --precision bf16": (am + [
                "--precision", "bf16", "--map_path", "bf16", "--score_path",
                "bf16_scores"], ("bf16", "bf16_scores")),
        }
        outs, walls = {}, {}

        def timed(name):
            t0 = time.perf_counter()
            outs[name] = run_cli(f"tpumil_torch.cli.{name.split()[0]}",
                                 common + runs[name][0], tmp)
            walls[name] = time.perf_counter() - t0

        # the f32 attention_map alone, then the other three side by side
        timed("attention_map")
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(timed, list(runs)[1:]))
        for name, (_, folders) in runs.items():
            for folder in folders:
                ext = ".csv" if folder.endswith("scores") else ".png"
                want = sorted(os.path.basename(d) + ext for d in bags)
                got = sorted(os.listdir(os.path.join(tmp, folder)))
                if got != want:
                    raise AssertionError(f"{name} wrote {got} to {folder}, "
                                         f"want {want}")
            if len(verdicts(outs[name])) != len(bags):
                raise AssertionError(f"{name} printed {outs[name]!r}")
        log(f"[attention_map] {len(bags)} bags of {list(AM_BAGS)} JPEG "
            f"patches of 224^2 on tile grids of {sides} columns with holes; "
            + "; ".join(f"python -m tpumil_torch.cli.{n} --device cuda exit "
                        f"0 in {walls[n]:.2f} s ({n_total / walls[n]:.1f} "
                        f"patches/s, start-up included"
                        f"{'' if i == 0 else ', three side by side'}), "
                        f"verdicts {verdicts(outs[n])}"
                        for i, n in enumerate(runs))
            + f"; a PNG per bag each, the CSVs where asked; {gpu}")

        # in-process, from the CLI's embedder and aggregator (f32, batch 64)
        emb, _, agg, model = load_milnet(emb_path, tcga, 2, dev)
        infer = BagInference(emb, agg, batch_size=AM_BATCH, model=model)
        # warm-up: a batch through the embedder, then the aggregator's
        # first call, timed (the CLIs pay it on their first bag)
        warm = torch.from_numpy(infer.extractor.embed_arrays(np.zeros(
            (AM_BATCH, 224, 224, 3), np.uint8))).to(dev)
        first = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                agg(warm, None, ins_logits=warm[:, :2])
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t0)
        per_bag = []

        def note(line):
            """After each bag's run_bag: its decode+embed+aggregate time."""
            st = infer.stats
            per_bag.append(st.embed_seconds + st.aggregate_seconds
                           - sum(per_bag))

        torch.cuda.synchronize()
        fused_stem.launches = fused_instance_norm.launches = 0
        t0 = time.perf_counter()
        results = run_attention_maps(
            infer, bags, THRESHOLDS, CLASSES, os.path.join(tmp, "inproc"),
            score_path=os.path.join(tmp, "inproc_scores"), seed=0, log=note)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k4 = fused_stem.launches, fused_instance_norm.launches
        batches = sum(-(-n // AM_BATCH) for n in AM_BAGS)
        if (k5, k4) != (batches, 19 * batches):
            raise AssertionError(f"K5/K4 launches {(k5, k4)} over {batches} "
                                 f"batches, want {(batches, 19 * batches)}")
        st = infer.stats
        split = (f"decode+embed {st.embed_seconds:.3f} s, aggregate "
                 f"{st.aggregate_seconds:.3f} s, render "
                 f"{st.render_seconds:.3f} s, PNG {st.png_seconds:.3f} s, CSV "
                 f"{st.csv_seconds:.3f} s")
        if [r.detected for r in results] != [
                [i for i, c in enumerate(CLASSES) if c in v]
                for v in verdicts(outs["attention_map"])]:
            raise AssertionError("in-process verdicts differ from the CLI's")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            infer.stats = HeatmapStats()
            t0 = time.perf_counter()
            run_attention_maps(infer, bags, THRESHOLDS, CLASSES,
                               os.path.join(tmp, "traced"), seed=0,
                               log=lambda s: None)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        events = device_events(prof)
        busy = (f"{busy_us(events) / 1e6 / traced * 100:.1f}% of the traced "
                f"wall {traced:.3f} s" if events else "not measured (no "
                "device events in the trace)")
        log(f"[attention_map] in-process run_attention_maps (f32, batch "
            f"{AM_BATCH}, 8 decode threads): {n_total} patches in {batches} "
            f"batches (each bag's last padded), K5/K4 launches {k5}/{k4} (1/19 "
            f"per batch); {wall:.3f} s = {n_total / wall:.1f} patches/s; per "
            f"bag (decode, embed, aggregate) "
            + ", ".join(f"{n}: {n / t:.1f} patches/s"
                        for n, t in zip(AM_BAGS, per_bag))
            + f"; {split}; device busy {busy}; the aggregator's first call "
            f"{first[0]:.3f} s, its second {first[1] * 1e3:.1f} ms (before "
            f"the run); {gpu}")

        # BagInference against embed_paths plus the aggregator on the card
        errs = []
        for d, r in zip(bags, results):
            feats = torch.from_numpy(infer.extractor.embed_paths(
                list_patches(d, exts=("jpg",)))).to(dev)
            with torch.inference_mode():
                logits = F.linear(feats, emb.fc.weight, emb.fc.bias)
                _, bag_logits, attn, _ = agg(feats, None, ins_logits=logits)
            for name, got, want in (
                    ("scores", r.scores, torch.sigmoid(bag_logits)),
                    ("attention", r.attention, attn)):
                errs.append(check_close(f"{os.path.basename(d)} {name}",
                                        torch.from_numpy(np.asarray(got)),
                                        want.cpu(), 1e-5, 0.0))
        # the 130-patch bag on the card against the port's CPU path
        small = bags[AM_BAGS.index(min(AM_BAGS))]
        got = infer.run_bag(small)
        emb_c, _, agg_c, _ = load_milnet(emb_path, tcga, 2,
                                         torch.device("cpu"))
        want = BagInference(emb_c, agg_c, batch_size=AM_BATCH,
                            model=model).run_bag(small)
        cpu_err = max(check_close(f"card vs CPU {name}",
                                  torch.from_numpy(g), torch.from_numpy(w),
                                  1e-4, 1e-4)
                      for name, g, w in zip(("scores", "attention",
                                             "ins_logits"), got, want))
        if not np.array_equal(got[3], want[3]):
            raise AssertionError("positions differ between card and CPU")
        log(f"[attention_map] BagInference vs embed_paths plus the aggregator "
            f"on the card, every bag: max_abs_err {max(errs):.3e} (atol "
            f"1e-5); the {min(AM_BAGS)}-patch bag, card vs the CPU path: "
            f"scores, attention, instance logits max_abs_err {cpu_err:.3e} "
            f"(atol 1e-4, rtol 1e-4)")

        # bf16 (K5's bf16 route) against f32, in-process and through the CLI
        emb_b, _, agg_b, _ = load_milnet(emb_path, tcga, 2, dev,
                                         precision="bf16")
        bf16 = [BagInference(emb_b, agg_b, batch_size=AM_BATCH,
                             model=model).run_bag(d)[0] for d in bags]
        if not all(np.isfinite(s).all() for s in bf16):
            raise AssertionError(f"bf16 scores not finite: {bf16}")
        gap = max(float(np.abs(b - r.scores).max())
                  for b, r in zip(bf16, results))
        same = verdicts(outs["attention_map"]) == \
            verdicts(outs["attention_map --precision bf16"])
        csv_gap = 0.0
        for d in bags:
            name = os.path.basename(d) + ".csv"
            a, b = (np.loadtxt(os.path.join(tmp, folder, name), delimiter=",",
                               skiprows=1, usecols=(0, 1))
                    for folder in ("am_scores", "bf16_scores"))
            if not np.isfinite(b).all():
                raise AssertionError(f"bf16 attention CSV {name} not finite")
            csv_gap = max(csv_gap, float(np.abs(a - b).max()))
        log(f"[attention_map] bf16 embedder vs f32: bag scores max gap "
            f"{gap:.3e} (in-process), attention CSVs max gap {csv_gap:.3e} "
            f"(the CLIs'); verdicts {'agree' if same else 'differ'} "
            f"(f32 {verdicts(outs['attention_map'])}, bf16 "
            f"{verdicts(outs['attention_map --precision bf16'])})")



# the SimCLR tree (bags x patches of 224^2), the CLI's batch, the batch of
# the card-against-CPU step, the timed batches and the reference's batch
SC_BAGS, SC_PATCHES, SC_BATCH, SC_CPU_B = 4, 80, 64, 8
SC_TIMED = (64, 512)
SC_REF_BATCH, SC_REF_MB = 4096, 128
# f32 gradients of a SimCLR step near its initialization are ill-conditioned:
# the views' projections nearly coincide, so dL/dz is a small difference of
# large terms, and its rounding error reaches every weight through the
# (linear) backward pass alike. On the CPU at batch 8, each tensor's f32
# gradient lies ~2e-3 (L2, relative) from float64's, up to ~4% in max
# norm. So each f32 gradient is held to a float64 gradient of the same
# weights and views: on every tensor, its relative L2 distance to float64
# may be at most SC_F64_FACTOR times the baseline f32 computation's largest
# (the CPU's; for grad-cache and remat, the card's monolithic step's), plus
# SC_F64_FLOOR. A cut gradient is 1.0 away. Losses agree to SC_LOSS_RTOL.
SC_F64_FACTOR, SC_F64_FLOOR, SC_LOSS_RTOL = 4.0, 1e-4, 1e-4
# the same step with TF32 allowed must lie at least this many times farther
# from float64: TF32 leaking into the backward convolutions would make the
# f32 tier's gradients as far off as TF32's
SC_TF32_FACTOR = 4.0
# kernel names of the normalization (F.instance_norm runs as batch norm)
NORM_KEYS = ("norm", "bn_fw", "bn_bw", "welford")


def simclr_grads(trainer, model, u, images):
    """(loss, {name: grad}) of one train step that leaves the weights as
    they are (SGD at lr 0): the step's own gradients, grad-cache or not."""
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    loss = trainer.train_step(model, opt, u, images, 0.0)
    return float(loss), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def simclr_f64_grads(model, u, images):
    """(loss, {name: grad}) in float64 of ``model``'s f32 weights on the
    f32 views of (u, images), on the model's device: the reference of the
    f32 gradients (the pooled features pass through f32, ~6e-8)."""
    from tpumil_torch.models.simclr import SimCLR, SimCLRConfig
    from tpumil_torch.ops.augment import augment_pair_batch
    from tpumil_torch.ops.nt_xent import l2_normalize, nt_xent_loss

    dev = model.l1.weight.device
    ref = SimCLR(SimCLRConfig(compute_dtype=torch.float64), dev).double()
    ref.load_state_dict(model.state_dict())
    views = augment_pair_batch(images.to(dev).float() / 255, u, 224,
                               torch.float32)
    z = [F.linear(torch.relu(F.linear(ref.backbone(v).double(), ref.l1.weight,
                                      ref.l1.bias)), ref.l2.weight, ref.l2.bias)
         for v in views]
    loss = nt_xent_loss(l2_normalize(z[0]), l2_normalize(z[1]), 0.5)
    loss.backward()
    return loss.item(), {n: p.grad.detach() for n, p in ref.named_parameters()}


def f64_errors(grads, ref):
    """{name: ||g - ref|| / ||ref||} (L2 over each tensor)."""
    return {k: ((grads[k].to(r.device).double() - r).norm()
                / r.norm()).item() for k, r in ref.items()}


def grads_as_accurate(name: str, errs, base: float) -> float:
    """Raises where a tensor's float64 distance passes SC_F64_FACTOR x
    ``base`` plus SC_F64_FLOOR; returns the largest distance."""
    for k, e in errs.items():
        if not (np.isfinite(e) and e <= SC_F64_FACTOR * base + SC_F64_FLOOR):
            raise AssertionError(
                f"{name}: {k} gradient {e:.3e} from float64 (relative L2), "
                f"the baseline's largest {base:.3e} (bar {SC_F64_FACTOR} x "
                f"baseline + {SC_F64_FLOOR})")
    return max(errs.values())


def loss_close(name: str, got: float, want: float) -> float:
    rel = abs(got - want) / abs(want)
    if not (np.isfinite(got) and rel <= SC_LOSS_RTOL):
        raise AssertionError(f"{name}: loss {got} against {want} (rel "
                             f"{rel:.3e}, bar {SC_LOSS_RTOL})")
    return rel


def losses_in(out: str):
    return [float(l.split(" loss ")[1].split()[0]) for l in out.splitlines()
            if l.startswith("epoch ") and " loss " in l]


def simclr_view_flops(model_cfg) -> float:
    """FLOPs of one 224^2 view through the SimCLR model, forward and
    backward (``torch.utils.flop_counter``: the convolutions and products,
    2 per multiply-add), on the card. The augmentation is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpumil_torch.models.simclr import init_model

    model = init_model(0, model_cfg, torch.device("cuda"))
    x = torch.rand(1, 224, 224, 3, device="cuda").to(model_cfg.compute_dtype)
    with FlopCounterMode(display=False) as fc:
        _, z = model(x)
        z.float().sum().backward()
    return float(fc.get_total_flops())


def simclr_step_time(model_cfg, b: int, images, mb=None, remat=False,
                     iters: int = 5):
    """(ms per step, peak bytes) of ``iters`` synced train steps at batch
    ``b`` after 2 warm-up steps, on the card."""
    from tpumil_torch.ops.augment import draw_uniforms
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    dev = torch.device("cuda")
    tr = SimCLRTrainer(model_cfg, SimCLRTrainConfig(
        batch_size=b, grad_cache_microbatch=mb, remat=remat), device=dev)
    model, opt = tr.init(0)
    gen = torch.Generator().manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        tr.train_step(model, opt, draw_uniforms(gen, b), images, 1e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = tr.train_step(model, opt, draw_uniforms(gen, b), images, 1e-5)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    if not np.isfinite(float(loss)):
        raise AssertionError(f"SimCLR loss not finite at batch {b}")
    peak = torch.cuda.max_memory_allocated()
    del model, opt, tr
    torch.cuda.empty_cache()
    return ms, peak


def phase_simclr(gpu: str) -> None:
    """SimCLR pretraining: the CLI a user runs (crashed after two epochs,
    then resumed with the grad-cache step), one full-width step on the card
    against the CPU, grad-cache and remat against the monolithic step, the
    K4/K5 counts of training (0), step times, peak memory and the busy
    share, then the trained model.pth through compute_feats' embedder."""
    from torch.profiler import ProfilerActivity, profile

    from tools.extract_profile import DATASET, write_tree
    from tools.serve_profile import busy_us, device_events
    from tpumil_torch.data.patches import decode_patch
    from tpumil_torch.models import embedder, resnet
    from tpumil_torch.models.simclr import SimCLRConfig, init_model
    from tpumil_torch.ops import instance_norm, stem
    from tpumil_torch.ops.augment import draw_uniforms
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    k4, k5 = instance_norm.fused_instance_norm, stem.fused_stem
    with tempfile.TemporaryDirectory() as tmp:
        wsi = os.path.join(tmp, "WSI")
        bag_dirs = write_tree(wsi, SC_BAGS, SC_PATCHES, 224, 11)
        n = SC_BAGS * SC_PATCHES
        run = os.path.join(tmp, "run")
        args = ["--device", "cuda", "--dataset", DATASET, "--wsi_root", wsi,
                "--batch_size", str(SC_BATCH), "--epochs", "3", "--config",
                "", "--run_dir", run]
        # 1. the CLI, killed once epoch 2's resume state is on disk (a
        # crash), then resumed with the grad-cache step; the epoch count is
        # part of the resume fingerprint, so both runs ask for 3
        meta = os.path.join(run, "state", "meta.json")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "tpumil_torch.cli.simclr_train",
             *args], cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO))
        epoch = 0
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 600:
                try:
                    with open(meta) as f:
                        epoch = json.load(f)["epoch"]
                except (OSError, ValueError, KeyError):
                    pass
                if epoch >= 2:
                    proc.kill()
                    break
                time.sleep(0.01)
        finally:
            if proc.poll() is None:
                proc.kill()
            out1 = proc.communicate(timeout=60)[0]
        wall1 = time.perf_counter() - t0
        if epoch != 2:
            raise AssertionError(f"simclr_train: the state read epoch "
                                 f"{epoch} at the kill, want 2:\n"
                                 f"{out1[-3000:]}")
        t0 = time.perf_counter()
        out2 = run_cli("tpumil_torch.cli.simclr_train",
                       args + ["--grad_cache", "16", "--resume"], tmp)
        wall2 = time.perf_counter() - t0
        if "Resuming SimCLR pretraining at epoch 2" not in out2:
            raise AssertionError(f"simclr_train did not resume at epoch 2:\n"
                                 f"{out2[-3000:]}")
        losses = losses_in(out1) + losses_in(out2)
        with open(os.path.join(run, "scalars.jsonl")) as f:
            scal = [json.loads(l) for l in f]
        valid = {r["step"]: r["value"] for r in scal
                 if r["tag"] == "validation_loss"}
        best = [l for l in out2.splitlines() if l.startswith("best valid")]
        ckpt = os.path.join(run, "checkpoints", "model.pth")
        if not (losses and sorted(valid) == [0, 1, 2] and best
                and np.isfinite(losses + list(valid.values())).all()
                and os.path.isfile(ckpt)):
            raise AssertionError(f"simclr_train: train losses {losses}, "
                                 f"validation losses {valid}, {best}, "
                                 f"model.pth {os.path.isfile(ckpt)}")
        rates = [l for l in (out1 + out2).splitlines()
                 if "patches/sec" in l]
        log(f"[simclr] python -m tpumil_torch.cli.simclr_train --device cuda "
            f"(resnet18-IN bf16, batch {SC_BATCH}, 224^2, {n} JPEG patches, "
            f"90/10 split): killed after epoch 2's state ({wall1:.2f} s), "
            f"then --grad_cache 16 --resume: resumed at epoch 2, exit 0 in "
            f"{wall2:.2f} s; logged train losses {losses}, validation "
            f"losses by epoch {valid}; {best[0]}; "
            f"{'; '.join(rates)}; {gpu}")

        # 2. one step at full width, f32: the card against the CPU, each
        # held to float64 on the same weights and views
        cfg32 = SimCLRConfig(compute_dtype=torch.float32)
        paths = sorted(os.path.join(d, f) for d in bag_dirs
                       for f in os.listdir(d))
        imgs = torch.from_numpy(np.stack([decode_patch(p, 224, False)
                                          for p in paths[:SC_BATCH]]))
        u = draw_uniforms(torch.Generator().manual_seed(5), SC_BATCH)
        tcfg = SimCLRTrainConfig(batch_size=SC_CPU_B)
        u8, imgs8 = u[:, :SC_CPU_B], imgs[:SC_CPU_B]
        model_cpu = init_model(0, cfg32, cpu)
        want_loss, want = simclr_grads(SimCLRTrainer(cfg32, tcfg, device=cpu),
                                       model_cpu, u8, imgs8)
        ref_loss, ref = simclr_f64_grads(model_cpu, u8, imgs8)
        base = f64_errors(want, ref)
        worst = max(base, key=base.get)
        k4.launches = k5.launches = 0
        got_loss, got = simclr_grads(SimCLRTrainer(cfg32, tcfg, device=dev),
                                     init_model(0, cfg32, dev), u8,
                                     imgs8.to(dev))
        torch.cuda.synchronize()
        counts = (k4.launches, k5.launches)
        cpu_loss = loss_close("card vs CPU", got_loss, want_loss)
        card_err = grads_as_accurate("card vs CPU", f64_errors(got, ref),
                                     base[worst])
        from tpumil_torch.models import simclr as simclr_mod
        from tpumil_torch.ops import augment as augment_mod
        from tpumil_torch.utils.device import disable_tf32

        callers = (resnet, simclr_mod, augment_mod)
        for mod in callers:
            mod.disable_tf32 = lambda: None
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, tf32 = simclr_grads(SimCLRTrainer(cfg32, tcfg, device=dev),
                                   init_model(0, cfg32, dev), u8,
                                   imgs8.to(dev))
        finally:
            for mod in callers:
                mod.disable_tf32 = disable_tf32
            disable_tf32()
        tf32_err = max(f64_errors(tf32, ref).values())
        if not tf32_err >= SC_TF32_FACTOR * card_err:
            raise AssertionError(f"the f32 step's gradients ({card_err:.3e} "
                                 f"from float64) are not clear of a TF32 "
                                 f"step's ({tf32_err:.3e})")
        g1 = got["backbone.conv1.weight"]
        if not (torch.isfinite(g1).all() and g1.abs().max() > 0):
            raise AssertionError("conv1 received no gradient on the card")
        if counts != (0, 0):
            raise AssertionError(f"K4/K5 launched {counts} times in SimCLR "
                                 "steps, want 0: the gradient would stop")
        log(f"[simclr] one f32 step at batch {SC_CPU_B} (224^2, same weights, "
            f"images and draws): card vs CPU loss {got_loss:.7f} vs "
            f"{want_loss:.7f} (rel {cpu_loss:.3e}, bar {SC_LOSS_RTOL}; float64 "
            f"{ref_loss:.7f}); each gradient's relative L2 distance to "
            f"float64: CPU up to {base[worst]:.3e} ({worst}), card up to "
            f"{card_err:.3e} (bar {SC_F64_FACTOR} x CPU + {SC_F64_FLOOR}), the "
            f"same step with TF32 allowed {tf32_err:.3e} (bar: at least "
            f"{SC_TF32_FACTOR} x the card's); "
            f"card vs CPU directly up to "
            f"{max(f64_errors(got, {k: v.double() for k, v in want.items()}).values()):.3e}"
            f"; conv1 grad max |g| {g1.abs().max().item():.3e}; "
            f"K4/K5 launches {counts[0]}/{counts[1]}")

        # grad-cache and remat against the monolithic step, on the card,
        # each held to float64 as above with the monolithic step as baseline
        imgs_d = imgs.to(dev)
        res = {}
        for name, kw in (("monolithic", {}),
                         ("grad-cache 16", {"grad_cache_microbatch": 16}),
                         ("remat", {"remat": True})):
            tr = SimCLRTrainer(cfg32, SimCLRTrainConfig(
                batch_size=SC_BATCH, **kw), device=dev)
            res[name] = simclr_grads(tr, init_model(0, cfg32, dev), u, imgs_d)
        torch.cuda.synchronize()
        if (k4.launches, k5.launches) != (0, 0):
            raise AssertionError("K4/K5 launched in SimCLR steps")
        _, ref = simclr_f64_grads(init_model(0, cfg32, dev), u, imgs_d)
        base_loss, base_grads = res.pop("monolithic")
        base = max(f64_errors(base_grads, ref).values())
        line = []
        for name, (loss, grads) in res.items():
            rl = loss_close(name, loss, base_loss)
            err = grads_as_accurate(name, f64_errors(grads, ref), base)
            direct = max(f64_errors(grads, {k: v.double() for k, v in
                                            base_grads.items()}).values())
            exact = all(torch.equal(grads[k], base_grads[k])
                        for k in base_grads)
            line.append(f"{name}: loss rel {rl:.3e}, float64 distance up to "
                        f"{err:.3e}, {direct:.3e} from the monolithic step"
                        f"{' (bitwise)' if exact else ''}")
        log(f"[simclr] f32 batch {SC_BATCH} on the card against the "
            f"monolithic step (its gradients up to {base:.3e} from float64, "
            f"relative L2; bars: loss {SC_LOSS_RTOL}, "
            f"{SC_F64_FACTOR} x + {SC_F64_FLOOR}): " + "; ".join(line))
        del res, base_grads, ref

        # 3. step times and peak memory
        gen = torch.Generator(device=dev).manual_seed(3)
        rand = torch.randint(0, 256, (max(SC_TIMED), 224, 224, 3),
                             dtype=torch.uint8, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            mcfg = SimCLRConfig(compute_dtype=dtype)
            flops = simclr_view_flops(mcfg)
            for b in SC_TIMED:
                remat = False
                try:
                    ms, peak = simclr_step_time(mcfg, b, rand[:b])
                except torch.cuda.OutOfMemoryError:
                    remat = True
                if remat:  # outside the handler, which holds the frames
                    torch.cuda.empty_cache()
                    log(f"[simclr] {str(dtype)[6:]} batch {b}: the "
                        f"monolithic step does not fit; with remat")
                    ms, peak = simclr_step_time(mcfg, b, rand[:b], remat=True)
                log(f"[simclr] resnet18-IN {str(dtype)[6:]} batch {b} (2 x "
                    f"{b} views of 224^2){' remat' if remat else ''}: "
                    f"{ms:.2f} ms per step, {2 * b / ms * 1e3:.1f} views/s, "
                    f"peak {peak / 2**30:.2f} GiB; the model's "
                    f"{flops / 1e9:.3f} GFLOP a view (forward and backward) "
                    f"at {2 * b * flops / (ms * 1e-3) / PEAK_FLOPS[dtype] * 100:.2f}"
                    f"% of the {str(dtype)[6:]} peak "
                    f"({PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s); {gpu}")
        del rand
        ref = torch.randint(0, 256, (SC_REF_BATCH, 224, 224, 3),
                            dtype=torch.uint8, device=dev, generator=gen)
        ms, peak = simclr_step_time(SimCLRConfig(), SC_REF_BATCH, ref,
                                    mb=SC_REF_MB, iters=2)
        log(f"[simclr] the reference's batch {SC_REF_BATCH}, bf16, "
            f"--grad_cache {SC_REF_MB}, device-made images: {ms:.1f} ms per "
            f"step, {2 * SC_REF_BATCH / ms * 1e3:.1f} views/s, peak "
            f"{peak / 2**30:.2f} GiB; {gpu}")
        del ref

        # the busy share and the normalization's share of a default step
        b = max(SC_TIMED)
        tr = SimCLRTrainer(SimCLRConfig(), SimCLRTrainConfig(batch_size=b),
                           device=dev)
        model, opt = tr.init(0)
        x = torch.randint(0, 256, (b, 224, 224, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
        g = torch.Generator().manual_seed(2)
        tr.train_step(model, opt, draw_uniforms(g, b), x, 1e-5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                tr.train_step(model, opt, draw_uniforms(g, b), x, 1e-5)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        events = device_events(prof)
        if events:
            kern = [e for e in events if e["cat"] == "kernel"]
            total = sum(float(e["dur"]) for e in kern)
            norm = sum(float(e["dur"]) for e in kern
                       if any(k in e["name"].lower() for k in NORM_KEYS))
            aug = sum(float(e["dur"]) for e in kern
                      if "reflection_pad" in e["name"].lower())
            by_name = {}
            for e in kern:
                by_name[e["name"][:48]] = by_name.get(e["name"][:48], 0.0) \
                    + float(e["dur"])
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            busy = (f"device busy {busy_us(events) / 1e6 / traced * 100:.1f}%"
                    f" of the traced wall {traced:.3f} s; kernels "
                    f"{total / 3e3:.2f} ms per step, normalization kernels "
                    f"{norm / total * 100:.1f}% of it, reflection pad "
                    f"{aug / total * 100:.1f}%; the top kernels: "
                    + ", ".join(f"{k} {v / total * 100:.1f}%" for k, v in top))
        else:
            busy = "device busy not measured (no device events in the trace)"
        log(f"[simclr] 3 default steps (bf16, batch {b}) under "
            f"torch.profiler: {busy}; {gpu}")
        del model, opt, tr, x

        # 4. the trained model.pth through compute_feats' embedder
        emb = embedder.load_simclr_checkpoint(ckpt, embedder.EmbedderConfig(),
                                              dev)
        with torch.inference_mode():
            k4.launches = k5.launches = 0
            feats, _ = emb(imgs_d)
            torch.cuda.synchronize()
            counts = (k4.launches, k5.launches)
            resnet.fused_instance_norm = instance_norm.instance_norm_plain
            resnet.fused_stem = stem.stem_plain
            try:
                plain, _ = emb(imgs_d)
            finally:
                resnet.fused_instance_norm, resnet.fused_stem = k4, k5
        if counts != (19, 1):
            raise AssertionError(f"the SimCLR embedder launched K4/K5 "
                                 f"{counts}, want (19, 1)")
        err = check_close("SimCLR embedder vs plain route", feats, plain,
                          1e-4, 1e-4)
        log(f"[simclr] model.pth through load_simclr_checkpoint (f32, batch "
            f"{SC_BATCH}): K4/K5 launches {counts[0]}/{counts[1]}, features "
            f"{tuple(feats.shape)} against the plain route max_abs_err "
            f"{err:.3e} (atol 1e-4, rtol 1e-4)")


def fold_scores(save: str) -> list:
    """(acc, thresholds) of each fold_k.done.json under ``save``."""
    out = []
    for k in range(5):
        with open(os.path.join(save, f"fold_{k}.done.json")) as f:
            meta = json.load(f)
        out.append((meta["acc"], meta["thresholds"]))
    return out


def phase_scale_out(gpu: str, wsi: dict) -> None:
    """The training half of scale-out at world 1 on NCCL (the one card;
    NCCL refuses two ranks on one GPU): the inst-sharded step against the
    eager step on the [train] bags, the train_wsi CLI with --inst_shard 1
    and --data_parallel 1 beside [train_wsi]'s run, a sharded fold state
    resumed mid-fold, and --inst_shard 2 refused before any work."""
    import torch.distributed as dist

    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.io import native_ckpt
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.ops import attention_pool as ap
    from tpumil_torch.parallel import bag_shard, mesh
    from tpumil_torch.train import schemes
    from tpumil_torch.train.trainer import BagTrainer

    dev = torch.device("cuda")
    cfg = DSMILConfig(K, C)
    world = mesh.make_mesh(1, 1, "cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"expected a world of 1 on nccl, got "
                             f"{dist.get_world_size()} on {dist.get_backend()}")
    sizes = (4000, 65529)
    store = DeviceBagStore(synthetic_bags(TRAIN_N, 3), device=dev)
    kernels = (ap.attention_pool_fwd, ap.attention_pool_bwd1,
               ap.attention_pool_bwd2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    peaks = {"sharded": [], "eager": []}
    for n in sizes:
        feats, label = store.bag(TRAIN_N.index(n)), store.label(
            TRAIN_N.index(n))
        sharded = bag_shard.InstanceShardedBagTrainer(
            cfg, weight_decay=1e-3, device=dev, mesh=world)
        eager = BagTrainer(cfg, weight_decay=1e-3, fused_threshold=None,
                           device=dev)
        ms, ps = sharded.init(torch.Generator().manual_seed(0))
        me, pe = eager.init(torch.Generator().manual_seed(0))
        for fn in kernels:  # the sharded path starts here
            fn.launches = 0
        bag_shard.collective.calls = 0
        sharded._train_bags(ms, ps, [(feats, label)] * 3, False, gen)
        torch.cuda.synchronize()
        calls = bag_shard.collective.calls / 3
        launched = [fn.launches for fn in kernels]
        eager._train_bags(me, pe, [(feats, label)] * 3, False, gen)
        worst = 0.0
        for name, want in me.state_dict().items():
            got = ms.state_dict()[name]
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-3, atol=2e-5, err_msg=name)
            worst = max(worst, float((got - want).abs().max()))
        if calls == 0 or any(launched):
            raise AssertionError(f"the sharded step ran {calls} collectives "
                                 f"and launched K1/K2/K3 {launched}")
        t = [step_ms(sharded, ms, ps, feats, label, False),
             step_ms(eager, me, pe, feats, label, False),
             step_ms(sharded, ms, ps, feats, label, False),
             step_ms(eager, me, pe, feats, label, False)]
        for route, tr, model, opt in (("sharded", sharded, ms, ps),
                                      ("eager", eager, me, pe)):
            peaks[route].append(peak_bytes(lambda: tr._train_bags(
                model, opt, [(feats, label)], False, gen)))
        log(f"[scale_out] N={n}: 3 inst-sharded steps (world 1, nccl) vs 3 "
            f"eager steps from the same init: params within rtol 1e-3 atol "
            f"2e-5, max |d| {worst:.3e}; {calls:.0f} collective calls a "
            f"step, K1/K2/K3 launches {launched}; ms per step (host clock, "
            f"synced, mean of 5, in turns): sharded {t[0]:.3f} / {t[2]:.3f},"
            f" eager {t[1]:.3f} / {t[3]:.3f}; peak bytes above residents: "
            f"sharded {peaks['sharded'][-1]} ({peaks['sharded'][-1] / n:.0f}"
            f" B per instance), eager {peaks['eager'][-1]} "
            f"({peaks['eager'][-1] / n:.0f}); {gpu}")
    dn = sizes[1] - sizes[0]
    log(f"[scale_out] working set per instance (slope over N={sizes}): "
        f"sharded {(peaks['sharded'][1] - peaks['sharded'][0]) / dn:.0f} B, "
        f"eager {(peaks['eager'][1] - peaks['eager'][0]) / dn:.0f} B")

    # one bf16 step, inst-sharded and unsharded, from the same weights: at
    # world 1 the sharded forward rounds the unnormalized softmax weights
    # and their sums where the eager one rounds the normalized weights, so
    # the two agree to bf16's precision, not bitwise
    cfg16 = DSMILConfig(K, C, compute_dtype=torch.bfloat16)
    n = sizes[-1]
    feats, label = store.bag(TRAIN_N.index(n)), store.label(TRAIN_N.index(n))
    sharded = bag_shard.InstanceShardedBagTrainer(
        cfg16, weight_decay=1e-3, device=dev, mesh=world)
    eager = BagTrainer(cfg16, weight_decay=1e-3, fused_threshold=None,
                       device=dev)
    ms, ps = sharded.init(torch.Generator().manual_seed(0))
    me, pe = eager.init(torch.Generator().manual_seed(0))
    for fn in kernels:  # the bf16 sharded step starts here
        fn.launches = 0
    bag_shard.collective.calls = 0
    loss_s = float(sharded._train_bags(ms, ps, [(feats, label)], False, gen))
    calls = bag_shard.collective.calls
    launched = [fn.launches for fn in kernels]
    loss_e = float(eager._train_bags(me, pe, [(feats, label)], False, gen))
    lr = ps.param_groups[0]["lr"]
    worst = max(float((ms.state_dict()[k] - v).abs().max())
                for k, v in me.state_dict().items())
    gap = abs(loss_s - loss_e) / abs(loss_e)
    # Adam's first step moves a weight by about lr either way, so weights
    # whose gradient signs differ lie 2 lr apart
    if gap > 2e-2 or worst > 2.0 * lr * (1 + 1e-3) or calls != 6 \
            or any(launched):
        raise AssertionError(
            f"bf16 inst-sharded step at N={n}: loss {loss_s} vs {loss_e} "
            f"(gap {gap:.3e}), params max |d| {worst:.3e}, {calls} "
            f"collectives, K1/K2/K3 launches {launched}")
    log(f"[scale_out] N={n}: one bf16 inst-sharded step (world 1, nccl) vs "
        f"the unsharded bf16 step from the same weights: loss {loss_s:.6f} "
        f"vs {loss_e:.6f}, relative gap {gap:.3e} (bar 2e-2); params max "
        f"|d| {worst:.3e} (bar 2 lr = {2 * lr:.0e}); {calls} collectives, "
        f"K1/K2/K3 launches {launched}; {gpu}")

    # the CLI, both modes at once beside [train_wsi]'s single-device run
    procs, t0 = {}, time.perf_counter()
    for mode in ("inst_shard", "data_parallel"):
        procs[mode] = subprocess.Popen(
            wsi["cmd"] + [f"--{mode}", "1", "--save_root", f"w_{mode}",
                          "--cache_dir", f"cache_{mode}"],
            cwd=wsi["tmp"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=REPO))
    walls = {}
    for mode, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        walls[mode] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"train_wsi --{mode} 1 exited "
                               f"{proc.returncode}:\n{out[-3000:]}\n"
                               f"{err[-3000:]}")
    day = os.path.basename(wsi["save"])
    want = fold_scores(wsi["save"])
    got = fold_scores(os.path.join(wsi["tmp"], "w_inst_shard", day))
    for (acc, th), (acc0, th0) in zip(got, want):
        np.testing.assert_allclose(th, th0, atol=1e-3)
        if acc != acc0:
            raise AssertionError(f"inst_shard 1 fold accuracy {acc} != {acc0}")
    dp = fold_scores(os.path.join(wsi["tmp"], "w_data_parallel", day))
    log(f"[scale_out] train_wsi --inst_shard 1 and --data_parallel 1 (run "
        f"side by side): exit 0 in {walls['inst_shard']:.2f} / "
        f"{walls['data_parallel']:.2f} s ([train_wsi] alone "
        f"{wsi['wall']:.2f} s); inst_shard fold accuracies "
        f"{[a for a, _ in got]} equal the single-device run's, thresholds "
        f"within 1e-3; data_parallel wrote 5 folds, accuracies "
        f"{[a for a, _ in dp]}")

    # a sharded fold state saved mid-fold (a crash after the 2nd save)
    # resumes on the uninterrupted trajectory
    bags = synthetic_bags(np.random.default_rng(6).integers(
        200, 3001, 18).tolist(), 7)
    wcfg = schemes.WSITrainConfig(feats_size=K, num_classes=C, num_epochs=4,
                                  stop_epochs=4, lr=1e-3,
                                  verbose=False, resume=True,
                                  fold_state_every=1, inst_shard=1,
                                  device=dev)
    trainer = schemes._make_trainer(wcfg)
    fp = schemes._cfg_fingerprint(wcfg, "5-fold-cv")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_state_")
    save, n_saves = native_ckpt.save_train_state, [0]

    def run(state_dir):
        return schemes.train_fold(
            trainer, bags[:12], bags[12:], wcfg, np.random.default_rng(3),
            torch.Generator().manual_seed(1), lambda s: None,
            state_dir=os.path.join(tmp, state_dir), state_fp=fp)

    def crash(path, state, *, meta=None):
        save(path, state, meta=meta)
        n_saves[0] += 1
        if n_saves[0] == 2:
            raise KeyboardInterrupt

    try:
        straight = run("s1")
        native_ckpt.save_train_state = crash
        try:
            run("s2")
            raise AssertionError("the fold did not crash")
        except KeyboardInterrupt:
            pass
        finally:
            native_ckpt.save_train_state = save
        resumed = run("s2")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = max(float((resumed["params"][k] - v).abs().max())
               for k, v in straight["params"].items())
    if resumed["acc"] != straight["acc"] or diff > 0.0:
        raise AssertionError(f"resumed fold: acc {resumed['acc']} vs "
                             f"{straight['acc']}, params max |d| {diff}")
    log(f"[scale_out] fold state saved at the 2nd of 4 boundaries, crashed, "
        f"resumed: best params bitwise the uninterrupted fold's, acc "
        f"{resumed['acc']:.4f}, thresholds {resumed['thresholds']}")
    dist.destroy_process_group()

    # too few devices: refused before any work
    t0 = time.perf_counter()
    proc = subprocess.run(wsi["cmd"] + ["--inst_shard", "2"], cwd=wsi["tmp"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    msg = "requested 2 devices but only 1 are available"
    if proc.returncode == 0 or msg not in proc.stderr \
            or "Creating intermediate" in proc.stdout:
        raise AssertionError(f"--inst_shard 2 on one card: exit "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    log(f"[scale_out] train_wsi --inst_shard 2 on one card: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.2f} s before any "
        f"work: {proc.stderr.strip().splitlines()[-1]}")


def _batch_ms(ex, batch, iters: int = 20) -> float:
    """ms per synced ``embed_arrays`` of ``batch`` (host clock), after
    three warm-up calls."""
    for _ in range(3):
        ex.embed_arrays(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        ex.embed_arrays(batch)
    return (time.perf_counter() - t0) / iters * 1e3


def _simclr_ms(tr, model, opt, u, images, iters: int = 10) -> float:
    """ms per synced train step (host clock), after two warm-up steps."""
    for _ in range(2):
        tr.train_step(model, opt, u, images, tr.cfg.lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = tr.train_step(model, opt, u, images, tr.cfg.lr)
    float(loss)
    return (time.perf_counter() - t0) / iters * 1e3


def phase_scale_out_embed(gpu: str, cf: dict) -> dict:
    """The embedding half of scale-out at world 1 on NCCL (the one card;
    NCCL refuses two ranks on one GPU): FeatureExtractor(mesh=...) against
    the single-device extractor (bitwise) and timed against it in turns,
    with K5/K4 counted on the sharded path; one sharded SimCLR step
    against the single-device step; then the CLIs with --data_parallel 1
    beside their single-device runs: compute_feats on [compute_feats]'s
    tree, attention_map on one of its bags, serve answering /v1/embed,
    simclr_train for one epoch; --data_parallel 2 refused on one card.
    Returns the sharded path's K5/K4 launches."""
    import signal

    import torch.distributed as dist

    from tpumil_torch.data.patches import list_bag_dirs, list_patches
    from tpumil_torch.infer.client import ServingClient
    from tpumil_torch.infer.features import FeatureExtractor
    from tpumil_torch.infer.service import InferenceService
    from tpumil_torch.models import embedder
    from tpumil_torch.models.simclr import SimCLRConfig
    from tpumil_torch.ops.augment import draw_uniforms
    from tpumil_torch.ops.instance_norm import fused_instance_norm
    from tpumil_torch.ops.stem import fused_stem
    from tpumil_torch.parallel import mesh
    from tpumil_torch.train.simclr_trainer import (SimCLRTrainConfig,
                                                   SimCLRTrainer)
    from tpumil_torch.utils import prof

    dev = torch.device("cuda")
    tmp = cf["tmp"]
    rng = np.random.default_rng(12)
    bag_dirs = list_bag_dirs(os.path.join(tmp, "WSI"), "synth", "single")
    paths = [p for d in bag_dirs for p in list_patches(d)][:2 * B]
    emb = embedder.load_simclr_checkpoint(
        os.path.join(tmp, "model.pth"), embedder.EmbedderConfig(num_classes=C),
        dev)
    with mesh.data_parallel(1, "extraction", "cuda") as world:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected a world of 1 on nccl, got "
                                 f"{dist.get_world_size()} on "
                                 f"{dist.get_backend()}")
        single = FeatureExtractor(emb, B, 224, 8)
        sharded = FeatureExtractor(emb, B, 224, 8, mesh=world)
        want = single.embed_paths(paths)
        # the sharded path starts here
        fused_stem.launches = fused_instance_norm.launches = 0
        mesh.feed_collective.calls = 0
        got = sharded.embed_paths(paths)
        torch.cuda.synchronize()
        launches = (fused_stem.launches, fused_instance_norm.launches)
        calls = mesh.feed_collective.calls
        if got.shape != (2 * B, 512) or not np.isfinite(got).all() \
                or not np.array_equal(got, want):
            raise AssertionError(f"sharded features {got.shape} differ from "
                                 f"the single-device ones by "
                                 f"{np.abs(got - want).max()}")
        if launches != (2, 2 * 19) or calls != 2 * 3:
            raise AssertionError(f"sharded path: K5/K4 launches {launches}, "
                                 f"{calls} collectives")
        odd = rng.integers(0, 256, (37, 224, 224, 3), np.uint8)
        if not np.array_equal(sharded.embed_arrays(odd),
                              single.embed_arrays(odd)):
            raise AssertionError("embed_arrays of 37 rows: sharded != single")
        batch = rng.integers(0, 256, (B, 224, 224, 3), np.uint8)
        prof.collect()
        with prof.recording():
            t = [_batch_ms(single, batch), _batch_ms(sharded, batch),
                 _batch_ms(sharded, batch), _batch_ms(single, batch)]
        by_name = {}  # mesh.<collective> -> [calls, ns]
        for sp in prof.collect():
            if sp.name.startswith("mesh."):
                by = by_name.setdefault(sp.name[5:], [0, 0])
                by[0] += 1
                by[1] += sp.end_ns - sp.start_ns
        batches = sum(n for n, _ in by_name.values()) / 3
        coll_ms = sum(ns for _, ns in by_name.values()) / batches / 1e6
        by_op = ", ".join(f"{name} {ns / n / 1e6:.3f}" for name, (n, ns)
                          in by_name.items())
        log(f"[scale_out_embed] FeatureExtractor(mesh) at world 1 (nccl): "
            f"embed_paths of {2 * B} JPEGs (2 batches of {B}, 224^2, f32) "
            f"bitwise the single-device features, embed_arrays of 37 rows "
            f"too; K5/K4 launches {launches}, {calls} collectives; ms per "
            f"synced batch of {B} (host clock, mean of 20, in turns): single "
            f"{t[0]:.3f} / {t[3]:.3f}, sharded {t[1]:.3f} / {t[2]:.3f}; "
            f"host ms in the 3 collectives a batch {coll_ms:.3f} ({by_op} "
            f"ms a call); {gpu}")

        # one SimCLR step, bf16 at batch 64, from the same init and draws
        images = torch.from_numpy(rng.integers(0, 256, (64, 224, 224, 3),
                                               np.uint8)).to(dev)
        u = draw_uniforms(torch.Generator().manual_seed(5), 64)
        cfg = SimCLRTrainConfig(batch_size=64)
        runs = {}
        for name, on in (("single", None), ("sharded", world)):
            tr = SimCLRTrainer(SimCLRConfig(), cfg, mesh=on, device=dev)
            model, opt = tr.init(0)
            start = {k: v.detach().clone() for k, v in
                     model.state_dict().items()}
            loss = float(tr.train_step(model, opt, u, images, cfg.lr))
            runs[name] = (tr, model, opt, loss, start)
        (trs, ms_, os_, ls, start), (trd, md, od, ld, _) = \
            runs["single"], runs["sharded"]
        if abs(ld - ls) > 1e-4 * abs(ls) or not np.isfinite(ld):
            raise AssertionError(f"sharded SimCLR loss {ld} vs {ls}")
        # one Adam step moves each weight by at most ~lr: the two steps'
        # weights may differ by up to 2 lr where a gradient element's sign
        # differs between two runs of the nondeterministic cuDNN backward
        gap, moved, differ, total = 0.0, 0.0, 0, 0
        sd, ss = md.state_dict(), ms_.state_dict()
        for k, v in ss.items():
            d = (sd[k].float() - v.float()).abs()
            gap = max(gap, float(d.max()))
            moved = max(moved, float((v.float() - start[k].float())
                                     .abs().max()))
            differ += int((d > 0).sum())
            total += d.numel()
        if gap > 2 * cfg.lr * (1 + 1e-3):
            raise AssertionError(f"sharded SimCLR weights {gap} from the "
                                 f"single-device step's (bar {2 * cfg.lr})")
        st = [_simclr_ms(trs, ms_, os_, u, images),
              _simclr_ms(trd, md, od, u, images),
              _simclr_ms(trd, md, od, u, images),
              _simclr_ms(trs, ms_, os_, u, images)]
        log(f"[scale_out_embed] SimCLR step, bf16, batch 64, world 1: loss "
            f"{ld:.6f} vs single-device {ls:.6f} (rtol 1e-4); weights after "
            f"one Adam step within {gap:.3e} of the single-device step's "
            f"(bar 2 lr = {2 * cfg.lr:.0e}; the step moved them up to "
            f"{moved:.3e}; {differ} of {total} differ); ms per step (host "
            f"clock, synced, mean of 10, in turns): single {st[0]:.2f} / "
            f"{st[3]:.2f}, sharded {st[1]:.2f} / {st[2]:.2f}")
        del runs, trs, ms_, os_, trd, md, od
        torch.cuda.empty_cache()

    # the CLIs, side by side
    am = os.path.join(tmp, "am_bags")
    os.makedirs(am)
    os.symlink(bag_dirs[0], os.path.join(am, "bag0"))
    agg = os.path.join(REPO, "tests", "data", "tcga_aggregator.pth")
    env = dict(os.environ, PYTHONPATH=REPO)

    def am_args(tag):
        return ["--device", "cuda", "--embedder_weights", "model.pth",
                "--aggregator_weights", agg, "--bag_path", "am_bags",
                "--patch_ext", "jpeg", "--map_path", f"maps_{tag}",
                "--export_scores", "1", "--score_path", f"scores_{tag}",
                "--seed", "0"]

    cmds = {
        "compute_feats": ("tpumil_torch.cli.compute_feats",
                          ["--device", "cuda", "--dataset", "synth",
                           "--weights", "model.pth", "--num_classes", str(C),
                           "--out_root", "dp_datasets", "--data_parallel",
                           "1"]),
        "attention_map": ("tpumil_torch.cli.attention_map", am_args("one")),
        "attention_map_dp": ("tpumil_torch.cli.attention_map",
                             am_args("dp") + ["--data_parallel", "1"]),
        "simclr_train": ("tpumil_torch.cli.simclr_train",
                         ["--device", "cuda", "--dataset", "synth",
                          "--wsi_root", "WSI", "--batch_size", "64",
                          "--epochs", "1", "--config", "", "--run_dir",
                          "simclr_dp", "--data_parallel", "1"]),
        "refused": ("tpumil_torch.cli.compute_feats",
                    ["--device", "cuda", "--dataset", "synth", "--weights",
                     "model.pth", "--out_root", "dp2", "--data_parallel",
                     "2"]),
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", mod, *args], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (mod, args) in cmds.items()}
    results = {}

    def collect(name):
        """Each command's output and its wall, taken when it ends."""
        out, err = procs[name].communicate(timeout=600)
        results[name] = (procs[name].returncode, out, err,
                         time.perf_counter() - t0)

    waiters = [threading.Thread(target=collect, args=(name,), daemon=True)
               for name in procs]
    for w in waiters:
        w.start()
    server = subprocess.Popen(
        [sys.executable, "-m", "tpumil_torch.cli.serve", "--device", "cuda",
         "--embedder_weights", "model.pth", "--num_classes", str(C),
         "--port", "0", "--data_parallel", "1"], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the single-device service's rows, in-process, meanwhile
        reqs = [rng.integers(0, 256, (n, 224, 224, 3), np.uint8)
                for n in (100, 37, 200)]
        ref = InferenceService(embedder.load_simclr_checkpoint(
            os.path.join(tmp, "model.pth"),
            embedder.EmbedderConfig(num_classes=C), dev), dev, batch_size=B)
        try:
            want_rows = [ref.embed(r) for r in reqs]
        finally:
            ref.close()
        url = None
        for line in server.stdout:
            m = re.search(r"http://[\d.]+:\d+", line)
            if m:
                url = m.group(0)
                break
        if url is None:
            raise RuntimeError(f"serve --data_parallel 1 did not start:\n"
                               f"{server.stderr.read()[-3000:]}")
        client = ServingClient(url, timeout=300)
        got_rows = [client.embed(r) for r in reqs]
        for g, w in zip(got_rows, want_rows):
            if not np.array_equal(g, w):
                raise AssertionError(f"served rows differ from the "
                                     f"single-device service's by "
                                     f"{np.abs(g - w).max()}")
        server.send_signal(signal.SIGTERM)
        out, err = server.communicate(timeout=120)
        if server.returncode != 0 or "draining" not in out:
            raise RuntimeError(f"serve --data_parallel 1 exited "
                               f"{server.returncode}:\n{out[-2000:]}\n"
                               f"{err[-2000:]}")
        log(f"[scale_out_embed] serve --data_parallel 1: {len(reqs)} "
            f"/v1/embed requests of {[len(r) for r in reqs]} rows equal the "
            f"single-device service's bitwise; SIGTERM -> exit 0 after "
            f"'draining'")
        for w in waiters:
            w.join()
    finally:
        for proc in (server, *procs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
    for name, (rc, out, err, _) in results.items():
        if (rc != 0) != (name == "refused"):
            raise RuntimeError(f"{name} exited {rc}:\n{out[-3000:]}\n"
                               f"{err[-3000:]}")
    rc, out, err, _ = results["refused"]
    msg = "requested 2 devices but only 1 are available"
    if msg not in err or "Use pretrained" in out:
        raise AssertionError(f"--data_parallel 2 on one card:\n{out[-2000:]}"
                             f"\n{err[-2000:]}")
    refusal = err.strip().splitlines()[-1]
    n_csv = 0
    for d in bag_dirs:
        rel = os.path.join(*d.split(os.path.sep)[-2:]) + ".csv"
        with open(os.path.join(tmp, "datasets", "synth", rel), "rb") as f, \
                open(os.path.join(tmp, "dp_datasets", "synth", rel),
                     "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"compute_feats --data_parallel 1: "
                                     f"{rel} differs")
        n_csv += 1
    with open(os.path.join(tmp, "scores_one", "bag0.csv"), "rb") as f, \
            open(os.path.join(tmp, "scores_dp", "bag0.csv"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("attention_map --data_parallel 1: the "
                                 "scores CSV differs")
    simclr_out = results["simclr_train"][1]
    if "best valid loss" not in simclr_out or not os.path.exists(
            os.path.join(tmp, "simclr_dp", "checkpoints", "model.pth")):
        raise AssertionError(f"simclr_train --data_parallel 1:\n"
                             f"{simclr_out[-2000:]}")
    walls = {name: r[3] for name, r in results.items()}
    log(f"[scale_out_embed] CLIs side by side (s from their start): "
        f"compute_feats --data_parallel 1 exit 0 in "
        f"{walls['compute_feats']:.2f} ({cf['cli_wall']:.2f} alone in "
        f"[compute_feats]), its {n_csv} CSVs equal the single-device run's "
        f"bytes; attention_map {walls['attention_map']:.2f}, with "
        f"--data_parallel 1 {walls['attention_map_dp']:.2f}, equal score "
        f"CSVs; simclr_train --data_parallel 1 (1 epoch, batch 64, "
        f"{len(bag_dirs) * CF_PATCHES} JPEGs) {walls['simclr_train']:.2f}: "
        f"{[l for l in simclr_out.splitlines() if 'best valid' in l][0]}; "
        f"--data_parallel 2 on one card: exit {rc} in "
        f"{walls['refused']:.2f} before any work: {refusal}")
    return {"launches": launches, "batch_ms": t, "collective_ms": coll_ms,
            "step_ms": st}


def dw_sites(n: int, seed: int):
    """TransMIL's two depthwise sites at bag size n, published widths: the
    residual conv's qkv [P, 1536] (its front P - T rows zero, as the model
    pads) with its weight, the PPEG's x [T, 512] with its six leaves, and
    an output gradient [T, 512] for each."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    side = int(np.ceil(np.sqrt(n)))
    t = side * side + 1
    big = 256 * -(-t // 256)
    qkv = rand(big, 1536)
    qkv[:big - t] = 0
    res = {"t": t, "big": big, "x": qkv, "dy": rand(t, 512),
           "leaves": [rand(8, 1, 33, 1, scale=33 ** -0.5)]}
    ppeg = {"t": t, "side": side, "x": rand(t, 512), "dy": rand(t, 512),
            "leaves": [rand(*shape, scale=0.1) for k in (7, 5, 3)
                       for shape in ((512, 1, k, k), (512,))]}
    return res, ppeg


def dw_calls(site: str, s: dict):
    """{variant: fn(x, *leaves) -> [T, 512]} of one site: the wrapper (the
    kernels), its plain version, and F.conv2d as the reference calls it."""
    from tpumil_torch.ops import depthwise as dw

    if site == "res_conv":
        t, big = s["t"], s["big"]

        def v(qkv):
            return qkv.view(big, 3, 8, 64).permute(1, 2, 0, 3)[2]

        def library(qkv, w):
            out = F.conv2d(v(qkv)[None], w, padding=(16, 0), groups=8)[0]
            return out.transpose(0, 1).reshape(big, -1)[-t:]

        return {"kernel": lambda qkv, w: dw.residual_conv(v(qkv), w, t),
                "plain": lambda qkv, w: dw.residual_conv_plain(v(qkv), w, t),
                "library": library}
    side = s["side"]

    def library(x, w7, b7, w5, b5, w3, b3):
        g = x[1:].transpose(0, 1).reshape(1, 512, side, side)
        conv = [F.conv2d(g, w, b, padding=w.shape[-1] // 2, groups=512)
                for w, b in ((w7, b7), (w5, b5), (w3, b3))]
        g = conv[0] + g + conv[1] + conv[2]
        return torch.cat([x[:1], g.reshape(512, -1).transpose(0, 1)])

    return {"kernel": lambda x, *w: dw.ppeg(x, side, *w),
            "plain": lambda x, *w: dw.ppeg_plain(x, side, *w),
            "library": library}


def dw_fwd_bwd(fn, s: dict):
    """fn's output and the gradients of (output * dy).sum() for its input
    and every leaf."""
    leaves = [t.detach().requires_grad_() for t in (s["x"], *s["leaves"])]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, s["dy"])]


def dw_device_us(fn, s: dict, calls: int = 5):
    """(device us of all kernels, of the package's dw_ kernels) per
    forward + backward of fn, from a torch.profiler trace of ``calls``
    synced calls after two warm-ups."""
    from torch.profiler import ProfilerActivity, profile

    from tools.serve_profile import device_events

    for _ in range(2):
        dw_fwd_bwd(fn, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            dw_fwd_bwd(fn, s)
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise AssertionError("[depthwise] the trace holds no device event")
    total = sum(float(e["dur"]) for e in events)
    ours = sum(float(e["dur"]) for e in events if "dw_" in e["name"])
    return total / calls, ours / calls


def dw_bound(site: str, s: dict):
    """The three passes' bound: each reads its input and writes its output
    once (the weight gradient reads two), 2048 B a row of 512 f32; and
    2 x taps FLOP an output element (the PPEG's forward: 49 + 25 + 9)."""
    t = s["t"]
    if site == "res_conv":
        # forward: T rows of v in, T out; input gradient: T of dy in, P of
        # dv out; weight gradient: T of v and T of dy in
        rows = 5 * t + s["big"]
        return bound(rows * 2048, 2 * 33 * 512 * (2 * t + s["big"]))
    grid = s["side"] ** 2
    return bound(3 * 2 * grid * 2048, 2 * (83 + 49 + 49) * 512 * grid)


def phase_depthwise(gpu: str) -> dict:
    """ops/depthwise's kernels against their plain versions at the main
    path's shapes, their device time beside the plain versions', ATen's
    and the bound, and one TransMIL training step's launches."""
    from torch.profiler import ProfilerActivity, profile

    from tpumil_torch.data.bags import Bag
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.ops import depthwise as dw
    from tpumil_torch.train.trainer import BagTrainer

    names = {"res_conv": ["out", "dqkv", "dw"],
             "ppeg": ["out", "dx", "dw7", "db7", "dw5", "db5", "dw3", "db3"]}
    wrappers = {"res_conv": dw.residual_conv, "ppeg": dw.ppeg}
    # forward, input gradient, weight gradient (the PPEG's: and its merge)
    per_call = {"res_conv": 3, "ppeg": 4}
    result = {site: {"by_n": {}} for site in names}
    failures = []
    for n in DW_N:
        sites = dict(zip(names, dw_sites(n, seed=n)))
        for site, s in sites.items():
            calls = dw_calls(site, s)
            wrappers[site].launches = 0
            got = dw_fwd_bwd(calls["kernel"], s)
            launches = wrappers[site].launches
            want = dw_fwd_bwd(calls["plain"], s)
            errs = {}
            for name, a, b in zip(names[site], got, want):
                if not torch.isfinite(a).all():
                    failures.append(f"{site} N={n} {name}: non-finite")
                scale = max(float(b.abs().max()), 1e-30)
                err = float((a - b).abs().max())
                errs[name] = (err, err / scale)
                if err > DW_RTOL * scale:
                    failures.append(f"{site} N={n} {name}: {err:.3e} of "
                                    f"max {scale:.3e}")
            if launches != per_call[site]:
                failures.append(f"{site} N={n}: {launches} launches")
            del got, want
            (us_k, us_dw), (us_p, _), (us_l, _) = (
                dw_device_us(calls[v], s) for v in ("kernel", "plain",
                                                    "library"))
            bound_ms, bound_by = dw_bound(site, s)
            result[site]["by_n"][n] = {
                "ms": us_dw / 1e3, "call_ms": us_k / 1e3,
                "plain_ms": us_p / 1e3, "library_ms": us_l / 1e3,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "launches_per_call": launches,
                "max_abs_err": max(e for e, _ in errs.values()),
                "max_err_of_max": max(r for _, r in errs.values())}
            log(f"[depthwise] {site} N={n} (T={s['t']}): forward + backward "
                f"in {launches} launches; |kernel - plain| / max|plain|: "
                + ", ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
                + f" (bar {DW_RTOL}); device ms: kernels {us_dw / 1e3:.4f} "
                f"(the whole call {us_k / 1e3:.4f}), plain "
                f"{us_p / 1e3:.4f}, F.conv2d as the reference calls it "
                f"{us_l / 1e3:.4f}; bound {bound_ms:.4f} ({bound_by}); {gpu}")
        del sites
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("[depthwise] kernels against plain: "
                             + "; ".join(failures))

    # one TransMIL bag step at the published widths, after a warm-up step
    dev = torch.device("cuda")
    n = DW_N[0]
    rng = np.random.default_rng(5)
    bags = [Bag(np.abs(rng.standard_normal((n, 1024), np.float32)),
                np.eye(2, dtype=np.float32)[1], "b0")]
    trainer = BagTrainer(DSMILConfig(1024, 2), weight_decay=1e-5,
                         model="transmil", device=dev)
    model, opt = trainer.init(torch.Generator().manual_seed(0))
    trainer.train_epoch(model, opt, bags, 2e-4, np.random.default_rng(1))
    torch.cuda.synchronize()
    dw.residual_conv.launches = dw.ppeg.launches = 0  # the step starts here
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, loss = trainer.train_epoch(model, opt, bags, 2e-4,
                                         np.random.default_rng(2))
        torch.cuda.synchronize()
    counts = (dw.residual_conv.launches, dw.ppeg.launches)
    kernels = {e.key for e in prof.key_averages()}
    aten = sorted(k for k in kernels if "conv_depthwise2d" in k)
    ours = sorted({re.search(r"dw_\w+", k).group(0) for k in kernels
                   if "dw_" in k})
    log(f"[depthwise] one TransMIL step, N={n}, K=1024: loss {loss:.6f}; "
        f"launches residual_conv {counts[0]}, ppeg {counts[1]} (want 6 "
        f"and 4); package kernels {ours}; ATen depthwise kernels {aten}")
    if counts != (6, 4) or aten or not ours or not np.isfinite(loss):
        raise AssertionError(f"[depthwise] the TransMIL step: launches "
                             f"{counts}, ATen's {aten}, ours {ours}, loss "
                             f"{loss}")
    result["res_conv"]["launches"], result["ppeg"]["launches"] = counts
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gpu = phase_device()
    compiler_log = phase_build()
    depthwise = phase_depthwise(gpu)
    k4 = phase_kernel(gpu)
    phase_embedder(gpu)
    phase_golden()
    launches = phase_serve(gpu)
    pool = phase_pool(gpu)
    train = phase_train(gpu)
    wsi = phase_train_wsi()
    phase_train_mil(gpu)
    stem = phase_stem(gpu)[torch.float32]
    k5_launches, cf = phase_compute_feats(gpu)
    try:
        phase_slide_feats(gpu)
        phase_attention_map(gpu)
        phase_simclr(gpu)
        pool_bf16 = phase_pool_bf16(gpu, compiler_log)
        phase_pipeline(gpu)
        try:
            phase_scale_out(gpu, wsi)
        finally:
            shutil.rmtree(wsi["tmp"], ignore_errors=True)
        phase_scale_out_embed(gpu, cf)
    finally:
        shutil.rmtree(cf["tmp"], ignore_errors=True)
    kernels = [{
        "name": "fused_instance_norm", "route": "cuda",
        "source": "tpumil_torch/csrc/instance_norm.cu",
        "replaces": "tpumil/ops/in_pallas.py:49",
        "launches": launches, **k4}]
    pool_src = "tpumil_torch/csrc/attention_pool.cu"
    # K3 as the training path launches it: feats need no gradient, no dF
    for (name, key, line), count in zip(
            (("attention_pool_fwd", "fwd", 39), ("attention_pool_bwd1", "bwd1", 195),
             ("attention_pool_bwd2", "bwd2_nodf", 216)), train["launches"]):
        kernels.append({
            "name": name, "route": "cuda", "source": pool_src,
            "replaces": f"tpumil/ops/dsmil_pallas.py:{line}",
            "launches": count, "max_abs_err": pool["err"][key.split("_")[0]],
            "ms": pool["ms"][key], "plain_ms": pool["ms"][key + "_plain"],
            "bound_ms": pool["bound"][key][0],
            "bound_by": pool["bound"][key][1], "library_ms": None})
    kernels.append({
        "name": "attention_pool_fwd_bf16", "route": "cuda",
        "source": "tpumil_torch/csrc/attention_pool_bf16.cu",
        "replaces": "tpumil/ops/dsmil_pallas.py:39",
        "launches": pool_bf16["launches"], "max_abs_err": pool_bf16["err"],
        "ms": pool_bf16["ms"]["kernel"], "plain_ms": pool_bf16["ms"]["plain"],
        "bound_ms": pool_bf16["bound"][0], "bound_by": pool_bf16["bound"][1],
        "library_ms": None})
    kernels.append({
        "name": "fused_stem", "route": "cuda",
        "source": "tpumil_torch/csrc/stem.cu",
        "replaces": "tpumil/ops/stem_pallas.py:84",
        "launches": k5_launches, **stem, "library_ms": None})
    # at the largest bag, N = 65536; launches: one TransMIL step's
    for site, name in (("res_conv", "residual_conv"), ("ppeg", "ppeg")):
        big = depthwise[site]["by_n"][DW_N[-1]]
        kernels.append({
            "name": f"depthwise.{name}", "route": "cuda",
            "source": "tpumil_torch/csrc/depthwise.cu", "replaces": None,
            "launches": depthwise[site]["launches"],
            "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "by_n": depthwise[site]["by_n"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
