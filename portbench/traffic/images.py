"""Tissue-like RGB patches, made on the device from a generator, and their
JPEG files.

A patch is white light through two stains at 224^2: an eosin (pink) field
that varies smoothly across the patch, hematoxylin (purple) nuclei as
blobs a few pixels wide, and fine grain, so that a JPEG of it holds the
edges and the entropy a tile of an H&E slide holds. Parameters, from a
cell's traffic:

    {"size": 224, "jpeg_quality": 70}

JPEGs are written with PIL at the tiler's quality, by a pool of threads
(PIL releases the interpreter lock while it encodes).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

# optical densities per unit stain (Ruifrok & Johnston's H&E vectors)
HEMATOXYLIN = (0.65, 0.70, 0.29)
EOSIN = (0.07, 0.99, 0.11)
CHUNK = 512


def tissue(n: int, size: int, generator, device):
    """``[n, size, size, 3]`` uint8 patches (NHWC)."""
    import torch
    import torch.nn.functional as F

    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    h_od = torch.tensor(HEMATOXYLIN, device=device).view(1, 3, 1, 1)
    e_od = torch.tensor(EOSIN, device=device).view(1, 3, 1, 1)
    for i in range(0, n, CHUNK):
        b = min(CHUNK, n - i)
        coarse = torch.rand((b, 1, 8, 8), generator=generator, device=device)
        eosin = F.interpolate(coarse, size=(size, size), mode="bicubic",
                              align_corners=False).clamp_(0, 1) * 0.9 + 0.1
        seeds = torch.rand((b, 1, size // 4, size // 4),
                           generator=generator, device=device)
        nuclei = F.interpolate((seeds > 0.85).float(), size=(size, size),
                               mode="bilinear", align_corners=False)
        nuclei = F.avg_pool2d(nuclei, 5, stride=1, padding=2) * 1.6
        grain = torch.randn((b, 3, size, size), generator=generator,
                            device=device) * 0.04
        od = eosin * e_od * 0.6 + nuclei * h_od + grain.abs()
        rgb = torch.exp(-od).clamp_(0, 1) * 255.0
        out[i:i + b] = rgb.round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def _save(img: np.ndarray, path: str, quality: int) -> None:
    from PIL import Image

    Image.fromarray(img).save(path, quality=quality)


def write_jpegs(images: np.ndarray, paths: Sequence[str], quality: int,
                workers: int = 8) -> None:
    """``images[i]`` (uint8 HWC) to ``paths[i]`` as JPEGs."""
    for d in {os.path.dirname(p) for p in paths}:
        os.makedirs(d, exist_ok=True)
    with ThreadPoolExecutor(workers) as pool:
        for f in [pool.submit(_save, images[i], p, quality)
                  for i, p in enumerate(paths)]:
            f.result()

