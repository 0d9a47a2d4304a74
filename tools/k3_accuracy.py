"""K3 (3xTF32 on the tensor cores) and its plain version (cuBLAS f32), each
against the same computation in float64, at the training path's width.

    python -m tools.k3_accuracy        # on a CUDA card

For each bag: every gradient's largest error against float64, relative to
the gradient's largest magnitude, for the kernel and for the plain
version. Bags are drawn as chip_smoke's [pool] draws them, once as they
come and once keeping only rows whose z1 (float64) stays 1e-5 or more off
the ReLU's kink: where some z1 lies within f32 rounding of 0, either f32
computation may take the other side of the kink, and that row's gradient
jumps.
"""

from __future__ import annotations

import sys

import torch

from chip_smoke import C, K, gpu_line, log

BAGS = [(65529, 0), (65529, 5), (20000, 5), (262144, 3)]  # (N, seed)
NAMES = ("dF", "dW0", "db0", "dW2", "db2", "dq_max")


def bag(n: int, seed: int, off_kink: bool):
    from tpumil_torch.ops.attention_pool import ATTN_DIM as D

    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale

    w = [t(D, K, scale=0.05), t(D, scale=0.1), t(D, D, scale=0.1),
         t(D, scale=0.1)]
    feats = t(n + n // 20 + 64, K, scale=1.0)
    if off_kink:
        z1 = feats.double() @ w[0].double().T + w[1].double()
        feats = feats[z1.abs().amin(dim=1) > 1e-5]
    return feats[:n].contiguous(), w, t(C, D, scale=0.5), t(C, K, scale=1.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_accuracy: needs a CUDA card", file=sys.stderr)
        return 2
    from tpumil_torch.ops import attention_pool as ap

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    for n, seed in BAGS:
        for off_kink in (False, True):
            feats, w, qm, db = bag(n, seed, off_kink)
            _, m, s, logits = ap.attention_pool_plain(feats, *w, qm, n)
            red = ap.attention_pool_bwd1_plain(feats, logits, m, s, db, n)
            args = (feats, *w, qm, m, s, db, red, n)
            got = ap.attention_pool_bwd2(*args)
            plain = ap.attention_pool_bwd2_plain(*args)
            ref = ap.attention_pool_bwd2_plain(*[a.double() for a in args[:-1]],
                                               n)
            cells = []
            for name, g, p, r in zip(NAMES, got, plain, ref):
                top = p.abs().max().item()
                cells.append(f"{name} kernel {(g.double() - r).abs().max().item() / top:.2e} "
                             f"plain {(p.double() - r).abs().max().item() / top:.2e}")
            log(f"[k3_accuracy] N={n} seed={seed} "
                f"{'off the kink' if off_kink else 'as drawn'}: error against "
                f"float64 / max|grad|: {'; '.join(cells)}; {gpu}")
            del feats, got, plain, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
