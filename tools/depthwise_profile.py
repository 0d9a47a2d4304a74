"""TransMIL's depthwise convolutions on the card: where their device time
goes in a bag step, and the kernels of ``ops/depthwise`` beside their
bound, their plain versions and ``F.conv2d``.

    python -m tools.depthwise_profile [CHECKOUT]    # on a CUDA card

``CHECKOUT`` (default: this repo) is the root of the tree whose
``tpumil_torch`` is imported, so that a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists can be read in turns
with this one in one call. One JSON line a checkout, with:

  * ``steps``: per bag size N (1024-d features, the published widths, one
    BagTrainer step over a device store), the step's ms by CUDA events
    (mean of 5 untraced) and the device's busy ms in one traced step (the
    union of its kernels), and every depthwise kernel of that step (ATen's
    ``conv_depthwise2d_*`` or this package's ``dw_*``) with its grid,
    block, device µs and site (``res_conv``, ``ppeg`` or the PPEG's
    ``merge``);
  * ``ops`` (only where the checkout has ``ops/depthwise``): per N and
    site, forward + backward of the wrapper, of its plain version and of
    ``F.conv2d`` as the reference calls it (one conv on ``v[None]``; the
    PPEG's three convs and their sum): ms by CUDA events (the mean of 20
    after 3 warm-ups; the host's pace at small N) and device ms (the sum of
    one call's kernels), the device µs of each of the wrapper's kernels,
    and the bound:
    each pass's input read once and output written once over 3.35 TB/s,
    against 2 x taps FLOP an output element over 67 TFLOP/s.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

SIZES = (256, 4096, 6758, 16384, 65536)
OP_SIZES = (4096, 6758, 65536)
BYTES_S, FLOPS_S = 3.35e12, 67e12


def _grid(n):
    side = math.isqrt(n - 1) + 1
    t = side * side + 1
    return side, t, 256 * -(-t // 256)


def _events(prof):
    """The trace's kernels as (name, grid, block, start µs, µs)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel":
            a = e.get("args", {})
            out.append((e["name"], a.get("grid"), a.get("block"),
                        float(e["ts"]), float(e["dur"])))
    return out


def _busy_us(events):
    spans = sorted((s, s + d) for _, _, _, s, d in events)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _site(name, grid, block, n):
    """Which conv an ATen or package kernel served: its weight gradient is
    one block per weight (8 x 33 for the residual conv), its other kernels
    one thread per output (P x 512 for the residual conv)."""
    if "dw_wgrad_rows" in name:
        return "res_conv"
    if "dw_band_kernel" in name:
        return "res_conv" if "33" in name.split("<", 1)[-1][:4] else "ppeg"
    if "dw_reduce" in name:
        return "merge"
    _, _, big = _grid(n)
    if "grad_weight" in name:
        return "res_conv" if grid[0] == 8 * 33 else "ppeg"
    return "res_conv" if grid[0] == -(-big * 512 // block[0]) else "ppeg"


def steps(card):
    from tpumil_torch.data.bags import Bag
    from tpumil_torch.data.device_store import DeviceBagStore
    from tpumil_torch.models.dsmil import DSMILConfig
    from tpumil_torch.train.trainer import BagTrainer

    out = {}
    rng = np.random.default_rng(0)
    for n in SIZES:
        bag = Bag(np.abs(rng.standard_normal((n, 1024), np.float32)),
                  np.eye(2, dtype=np.float32)[n % 2], f"n{n}")
        store = DeviceBagStore([bag], device=card)
        tr = BagTrainer(DSMILConfig(1024, 2), weight_decay=1e-5,
                        model="transmil", device=card)
        model, opt = tr.init(torch.Generator().manual_seed(0))
        step_rng = np.random.default_rng(1)
        for _ in range(2):
            tr.train_epoch(model, opt, store, 2e-4, step_rng)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            tr.train_epoch(model, opt, store, 2e-4, step_rng)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tr.train_epoch(model, opt, store, 2e-4, step_rng)
            torch.cuda.synchronize()
        ev = _events(prof)
        dws = [{"name": name[:80], "grid": g, "block": b, "us": round(d, 2),
                "site": _site(name, g, b, n)}
               for name, g, b, _, d in ev
               if "depthwise" in name or "dw_" in name]
        by_site = {}
        for k in dws:
            by_site[k["site"]] = round(by_site.get(k["site"], 0) + k["us"], 2)
        out[n] = {"step_ms": round(float(np.mean(ms)), 4),
                  "busy_ms": round(_busy_us(ev) / 1e3, 4),
                  "depthwise_us": by_site, "kernels": dws}
        del store, model, opt, tr
        torch.cuda.empty_cache()
    return out


def _time(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def ops(card):
    from tpumil_torch.ops import depthwise as dw

    g = torch.Generator(device=card).manual_seed(0)
    out = {}
    for n in OP_SIZES:
        side, t, big = _grid(n)
        qkv = torch.randn(big, 1536, device=card, generator=g)
        qkv[:big - t] = 0
        qkv.requires_grad_()
        w = (torch.randn(8, 1, 33, 1, device=card, generator=g)
             * 33 ** -0.5).requires_grad_()
        x = torch.randn(t, 512, device=card, generator=g).requires_grad_()
        convs = [(torch.randn(s, device=card, generator=g) * 0.1)
                 .requires_grad_() for k in (7, 5, 3)
                 for s in ((512, 1, k, k), (512,))]
        dy = torch.randn(t, 512, device=card, generator=g)

        def v():
            return qkv.view(big, 3, 8, 64).permute(1, 2, 0, 3)[2]

        def library_res():
            y = F.conv2d(v()[None], w, padding=(16, 0), groups=8)[0, :, big - t:]
            return y.transpose(0, 1).reshape(t, -1)

        def library_ppeg():
            gr = x[1:].transpose(0, 1).view(1, 512, side, side)
            gr = sum((F.conv2d(gr, convs[2 * i], convs[2 * i + 1],
                               padding=k // 2, groups=512)
                      for i, k in enumerate((7, 5, 3))), gr)
            return torch.cat([x[:1], gr.flatten(2)[0].transpose(0, 1)])

        def fwd_bwd(f, leaves):
            return lambda: torch.autograd.grad((f() * dy).sum(), leaves)

        res_leaves, ppeg_leaves = [qkv, w], [x, *convs]
        row = {}
        for site, kernel, plain, library, leaves, taps, rows in (
                ("res_conv", lambda: dw.residual_conv(v(), w, t),
                 lambda: dw.residual_conv_plain(v(), w, t), library_res,
                 res_leaves, 33, (big, t)),
                ("ppeg", lambda: dw.ppeg(x, side, *convs),
                 lambda: dw.ppeg_plain(x, side, *convs), library_ppeg,
                 ppeg_leaves, 49, (side * side, side * side))):
            in_b, out_b = 4 * 512 * rows[0], 4 * 512 * rows[1]
            nbytes = 3 * (in_b + out_b)  # forward, input and weight gradient
            flops = 3 * 2 * taps * 512 * rows[1]
            row[site] = {}
            for name, f in (("kernel", kernel), ("plain", plain),
                            ("library", library)):
                row[site][f"{name}_ms"] = round(_time(fwd_bwd(f, leaves)), 4)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fwd_bwd(f, leaves)()
                    torch.cuda.synchronize()
                ev = _events(prof)
                row[site][f"{name}_device_ms"] = round(
                    sum(d for *_, d in ev) / 1e3, 4)
                if name == "kernel":
                    per_kernel = {}
                    for kname, _, _, _, d in ev:
                        if "dw_" in kname:
                            key = re.search(r"dw_\w+(<[^>]*>)?",
                                            kname).group(0)
                            per_kernel[key] = round(
                                per_kernel.get(key, 0) + d, 2)
                    row[site]["kernels_us"] = per_kernel
            row[site].update({
                "bound_ms": round(1e3 * max(nbytes / BYTES_S,
                                            flops / FLOPS_S), 4),
                "bound_by": "bytes" if nbytes / BYTES_S > flops / FLOPS_S
                else "operations", "mbytes": round(nbytes / 1e6, 1)})
        out[n] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("depthwise_profile: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    import tpumil_torch

    assert os.path.dirname(os.path.dirname(tpumil_torch.__file__)) == root
    card = torch.device("cuda")
    has_ops = os.path.exists(os.path.join(root, "tpumil_torch", "ops",
                                          "depthwise.py"))
    line = {"checkout": os.path.basename(root),
            "device": torch.cuda.get_device_name(0), "steps": steps(card)}
    if has_ops:
        line["ops"] = ops(card)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
