"""Fixed-grid cropper for demo and test slides (counterpart of
tpumil/cli/crop_single.py; host only, so no ``--device``): reads level-1
regions on a step grid, keeps patches by mean HSV saturation (threshold
30), saves ``<row>_<col>.jpg`` plus a thumbnail.

    python -m tpumil_torch.cli.crop_single --dataset tcga|c16

Reads ``test/input/*.{svs,tif}`` (``test-c16/`` for c16) and writes
``patches/<slide>/`` and ``thumbnails/<slide>.png`` beside it. Grid
locations use the slide's true downsample of the level read (1.0 when a
one-level slide reads level 0), not the reference's hard-coded 4.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def crop_slide_grid(slide_path: str, out_dir: str, thumb_dir: str,
                    step: int = 224, patch_size: int = 224,
                    sat_threshold: float = 30.0, thumb_divisor: int = 7,
                    log=print) -> int:
    """Crop one slide; returns the number of patches kept."""
    from PIL import Image

    from tpumil_torch.data.slide import open_slide
    from tpumil_torch.ops.image import mean_saturation_ubyte

    slide = open_slide(slide_path)
    try:
        level = 1 if slide.level_count > 1 else 0
        factor = slide.level_downsample(level)  # 1.0 when reading level 0
        w, h = slide.level_dimensions[level]
        name = os.path.splitext(os.path.basename(slide_path))[0]
        bag = os.path.join(out_dir, name)
        os.makedirs(bag, exist_ok=True)
        os.makedirs(thumb_dir, exist_ok=True)
        # the thumbnail is 1/thumb_divisor of the cropped level, read from
        # the smallest pyramid level that still covers it
        tw, th = max(1, int(w / thumb_divisor)), max(1, int(h / thumb_divisor))
        tlvl = level
        for cand in range(slide.level_count - 1, level - 1, -1):
            if slide.level_dimensions[cand][0] >= tw:
                tlvl = cand
                break
        cw, ch = slide.level_dimensions[tlvl]
        thumb = slide.read_region((0, 0), tlvl, (cw, ch))
        Image.fromarray(thumb).resize((tw, th)).save(
            os.path.join(thumb_dir, name + ".png"))
        kept = 0
        for j in range(h // step):           # rows
            for i in range(w // step):       # columns
                region = slide.read_region(
                    (int(i * step * factor), int(j * step * factor)),
                    level, (patch_size, patch_size))
                if mean_saturation_ubyte(region) >= sat_threshold:
                    Image.fromarray(region).save(
                        os.path.join(bag, f"{j}_{i}.jpg"))
                    kept += 1
            log(f"\r Cropped rows: {j + 1}/{h // step}")
        log("")
        return kept
    finally:
        slide.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate patches from testing slides")
    parser.add_argument("--dataset", type=str, default="tcga", help="tcga|c16")
    parser.add_argument("--overlap", type=int, default=0)
    parser.add_argument("--patch_size", type=int, default=224)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    base = "test" if args.dataset == "tcga" else "test-c16"
    path_base = os.path.join(base, "input")
    out_base = os.path.join(base, "patches")
    thumb_dir = os.path.join(base, "thumbnails")
    slides = (glob.glob(os.path.join(path_base, "*.svs"))
              + glob.glob(os.path.join(path_base, "*.tif")))
    print("Cropping patches, please be patient")
    step = args.patch_size - args.overlap
    # thumbnails at 1/7 (tcga) or 1/28 (c16) of the cropped level
    divisor = 7 if args.dataset == "tcga" else 28
    for s in slides:
        crop_slide_grid(s, out_base, thumb_dir, step, args.patch_size,
                        thumb_divisor=divisor)
    return 0


if __name__ == "__main__":
    sys.exit(main())
