"""K4's one-read route at every cluster size and channel block that fits,
against the two-read route, at the ResNet18-IN planes (B = 128): the data
behind ``ops/instance_norm.plan_instance_norm``.

    python -m tools.in_sweep           # on a CUDA card

Each line is one (dtype, plane): the planned route's device time and, per
(cluster / channels per block), the device time of a forced launch (CUDA
graph replay, relu on), beside the bytes bound (one read and one write at
3.35 TB/s). Forced launches bypass the wrapper and its launch counter.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from chip_smoke import HBM_BYTES_PER_S, graph_ms, gpu_line, log

PLANES = [(112, 64), (56, 64), (28, 128), (14, 256), (7, 512)]
B = 128
MAX_SLICE = 200 * 1024  # what one CTA's shared memory can hold


def main() -> int:
    if not torch.cuda.is_available():
        print("in_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from tpumil_torch.ops.instance_norm import (EPS, _DTYPE_CODES,
                                                fused_instance_norm,
                                                plan_instance_norm)
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    gpu = gpu_line()
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        for h, c in PLANES:
            x = torch.from_numpy(rng.standard_normal((B, h, h, c), np.float32)
                                 ).to("cuda", dtype)
            y = torch.empty_like(x)
            elt = x.element_size()

            def forced(cluster, cblock):
                return lib.tpumil_instance_norm(
                    x.data_ptr(), y.data_ptr(), B, h * h, c,
                    _DTYPE_CODES[dtype], 1, EPS, cluster, cblock,
                    torch.cuda.current_stream().cuda_stream)

            plan = plan_instance_norm(x.shape, dtype)
            bound = 2 * x.numel() * elt / HBM_BYTES_PER_S * 1e3
            cells = [f"plan {plan.cluster}/{plan.cblock} "
                     f"{graph_ms(lambda: fused_instance_norm(x, True)):.4f}",
                     f"two-read {graph_ms(lambda: forced(0, c)):.4f}"]
            for cblock in sorted({min(c, 256 // elt), min(c, 128 // elt)},
                                 reverse=True):
                for cluster in (1, 2, 4, 8):
                    if -(-h * h // cluster) * cblock * elt > MAX_SLICE:
                        continue
                    if forced(cluster, cblock) != 0:
                        cells.append(f"{cluster}/{cblock} refused")
                        continue
                    cells.append(f"{cluster}/{cblock} "
                                 f"{graph_ms(lambda: forced(cluster, cblock)):.4f}")
            log(f"[in_sweep] {str(dtype)[6:]} [{B},{h},{h},{c}] device ms "
                f"(cluster/channels): {'; '.join(cells)}; bound {bound:.4f}; "
                f"{gpu}")
            del x, y
    return 0


if __name__ == "__main__":
    sys.exit(main())
