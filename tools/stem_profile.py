"""K5 (``ops/stem.fused_stem``) at B = 128, f32 and bf16: the whole launch by
CUDA events and each of its two kernels by ``torch.profiler``, with the
registers and spills ptxas reports for pass 1.

    python -m tools.stem_profile [CHECKOUT]    # on a CUDA card

``CHECKOUT`` (default: this repo) is the root of the tree whose
``tpumil_torch`` is imported and built, so that two commits (one unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) or a
modified copy of ``csrc/stem.cu`` can be timed in turns in one call. The
line reads: the checkout's name, then per dtype the ms of one launch (20
after 3 warm-ups), pass 1 (``stem_conv_pool_kernel``) and pass 2
(``stem_norm_kernel``) in device ms (mean of 10), then ptxas's lines for
pass 1 when this process built the library (none when it was cached).
"""

import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else ".")
    from tpumil_torch.ops.stem import fused_stem
    from tpumil_torch.utils import build

    _, _, log = build.build(verbose=True)
    keep, name, regs = False, "", []
    for line in log.splitlines():
        if "Function properties for" in line:
            keep = "stem_conv_pool" in line
            name = "bf16" if "bfloat16" in line else "f32"
        elif keep and "registers" in line:
            regs.append(f"{name}: {line.split(':', 1)[1].strip()}")
        elif keep and "spill" in line:
            regs.append(f"{name}: {line.strip()}")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((128, 224, 224, 3), np.float32)).cuda()
    w = torch.from_numpy((rng.standard_normal((7, 7, 3, 64)) * 0.025)
                         .astype(np.float32)).cuda()
    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for _ in range(3):
            fused_stem(x, w, dtype)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(20):
            fused_stem(x, w, dtype)
        ev[1].record()
        ev[1].synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused_stem(x, w, dtype)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if "stem" in e.key:
                t = getattr(e, "device_time_total", None) \
                    or getattr(e, "cuda_time_total", 0)
                per["conv_pool" if "conv_pool" in e.key else "norm"] = \
                    t / 10 / 1e3
        res.append(f"{str(dtype)[6:]} {ms:.4f} ms; pass1 "
                   f"{per.get('conv_pool', -1):.4f} pass2 "
                   f"{per.get('norm', -1):.4f}")
    print(sys.path[0].split('/')[-1], " | ".join(res), " | ",
          "; ".join(regs), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
