"""WSI patch extraction: slides -> background-filtered JPEG patch folders,
with the reference deepzoom_tiler.py's flags (counterpart of
tpumil/cli/tiler.py; host only, so no ``--device``).

    python -m tpumil_torch.cli.tiler -d <dataset> -v tif [-m 0 2]

Reads ``<wsi_root>/<dataset>/<class>/*.<slide_format>`` and writes
``<wsi_root>/<dataset>/{single,pyramid}/<class>/<slide>/``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Patch extraction for WSI (PyTorch port)")
    parser.add_argument("-d", "--dataset", type=str, default="TCGA-lung")
    parser.add_argument("-e", "--overlap", type=int, default=0)
    parser.add_argument("-f", "--format", type=str, default="jpeg")
    parser.add_argument("-v", "--slide_format", type=str, default="svs")
    parser.add_argument("-j", "--workers", type=int, default=4)
    parser.add_argument("-q", "--quality", type=int, default=70)
    parser.add_argument("-s", "--tile_size", type=int, default=224)
    parser.add_argument("-b", "--base_mag", type=float, default=20)
    parser.add_argument("-m", "--magnifications", type=int, nargs="+",
                        default=(0,))
    parser.add_argument("-o", "--objective", type=float, default=20)
    parser.add_argument("-t", "--background_t", type=float, default=15)
    parser.add_argument("--wsi_root", type=str, default="WSI")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    from tpumil_torch.data.tiler import TilerConfig, tile_dataset

    levels = tuple(sorted(args.magnifications))
    if len(levels) > 2:
        parser.error("Only 1 or 2 magnifications are supported!")
    cfg = TilerConfig(tile_size=args.tile_size, overlap=args.overlap,
                      quality=args.quality,
                      background_threshold=args.background_t,
                      workers=args.workers, base_mag=args.base_mag,
                      objective=args.objective, format=args.format)
    tile_dataset(args.wsi_root, args.dataset, levels, cfg, args.slide_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
