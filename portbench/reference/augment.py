"""A frozen copy of the SimCLR augmentation arithmetic (the reference's
SimCLRDataTransform at s = 1, simclr/data_aug/dataset_wrapper.py:48-58, as
``tpumil_torch/ops/augment.py`` computes it from per-view uniforms), kept
here so that the reference depends on nothing of the program.

From the ``[2, B, N_UNIFORMS]`` uniforms of a batch: RandomResizedCrop
(area U(0.08, 1), log-ratio U(log 3/4, log 4/3), 10 attempts, bilinear with
antialiasing as two batched products), horizontal flip p 0.5, ColorJitter
(0.8, 0.8, 0.8, 0.2) p 0.8 (brightness, contrast, saturation, then hue as
a YIQ rotation), grayscale p 0.2, Gaussian blur (13 taps, sigma U(0.1, 2),
reflect-101) p 0.5. Products take their operands in the images' dtype and
sum in f32; bf16 images round each product's output to bf16. The caller
turns TF32 off.

Imports torch alone: nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

ATTEMPTS = 10
# one view's uniforms: RandomResizedCrop's areas and log-aspects (one per
# attempt) and its origin, then the coins and the jitter and blur draws
AREA = slice(0, ATTEMPTS)
ASPECT = slice(ATTEMPTS, 2 * ATTEMPTS)
X0, Y0, FLIP, JITTER = 20, 21, 22, 23
FACTORS = slice(24, 28)  # brightness, contrast, saturation, hue
GRAY, BLUR, SIGMA = 28, 29, 30
N_UNIFORMS = 31
SCALE = (0.08, 1.0)               # RandomResizedCrop's area fraction
RATIO = (3.0 / 4.0, 4.0 / 3.0)    # and aspect ratio
BLUR_KERNEL = 13                  # int(0.06 * 224) taps
_F32_EPS = 1.1920928955078125e-07  # np.finfo(np.float32).eps


class ViewParams(NamedTuple):
    """Per-image parameters of one view ([B] or [B, k] tensors)."""
    box: torch.Tensor      # [B, 4] f32: crop height, width, y0, x0
    flip: torch.Tensor     # [B] bool
    jitter: torch.Tensor   # [B] bool
    factors: torch.Tensor  # [B, 4] f32: brightness, contrast, saturation, hue
    gray: torch.Tensor     # [B] bool
    blur: torch.Tensor     # [B] bool
    sigma: torch.Tensor    # [B] f32


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its unit draw:
    ``max(lo, u * (hi - lo) + lo)`` in f32, the product and sum rounded once
    (XLA contracts them into a fused multiply-add; a float64 product of two
    f32 values is exact)."""
    lo32 = torch.tensor(float(lo), dtype=torch.float32)
    span = (torch.tensor(float(hi), dtype=torch.float32) - lo32).double()
    out = (u.double() * span.to(u.device) + lo32.double().to(u.device)).float()
    return torch.maximum(lo32.to(u.device), out)


def crop_box(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """RandomResizedCrop's box ``[B, 4]`` (height, width, y0, x0) from
    ``[B, N_UNIFORMS]`` uniforms: the first of the attempts that fits, else
    the full frame, centred (tpumil/ops/augment.py::rrc_params)."""
    areas = h * w * _scaled(u[:, AREA], SCALE[0], SCALE[1])
    # the log-ratio bounds rounded from float64, as XLA's f32 log gives them
    aspects = torch.exp(_scaled(u[:, ASPECT], math.log(RATIO[0]),
                                math.log(RATIO[1])))
    # correctly rounded square roots, as XLA's (float64 is exact enough)
    cws = torch.sqrt((areas * aspects).double()).float()
    chs = torch.sqrt((areas / aspects).double()).float()
    valid = (cws <= w) & (chs <= h) & (cws >= 1) & (chs >= 1)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    cw = torch.where(any_valid, cws.gather(1, first)[:, 0], float(w))
    ch = torch.where(any_valid, chs.gather(1, first)[:, 0], float(h))
    x0 = torch.where(any_valid, u[:, X0] * (w - cw), (w - cw) / 2)
    y0 = torch.where(any_valid, u[:, Y0] * (h - ch), (h - ch) / 2)
    return torch.stack([ch, cw, y0, x0], dim=1)


def view_params(u: torch.Tensor, h: int, w: int,
                strength: float = 1.0) -> ViewParams:
    """Map one view's uniforms ``[B, N_UNIFORMS]`` of ``h x w`` images to
    its parameters (the draws of tpumil/ops/augment.py::augment_one)."""
    lo = max(0.0, 1 - 0.8 * strength)
    hi = 1 + 0.8 * strength
    hue = 0.2 * strength
    factors = torch.stack([_scaled(u[:, FACTORS][:, k], lo, hi)
                           for k in range(3)]
                          + [_scaled(u[:, FACTORS][:, 3], -hue, hue)], dim=1)
    return ViewParams(box=crop_box(u, h, w), flip=u[:, FLIP] < 0.5,
                      jitter=u[:, JITTER] < 0.8, factors=factors,
                      gray=u[:, GRAY] < 0.2, blur=u[:, BLUR] < 0.5,
                      sigma=_scaled(u[:, SIGMA], 0.1, 2.0))


def _resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """[B, in, out] bilinear weights with antialiasing, per image: the
    specification is jax/_src/image/scale.py::compute_weight_mat (sample
    positions ``(i + 0.5 - t)/s - 0.5``, a triangle kernel widened by
    ``max(1/s, 1)``, weights normalized unless their sum is below 1000 eps,
    samples outside ``[-0.5, in - 0.5]`` zeroed)."""
    dev = scale.device
    inv = torch.reciprocal(scale)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
              [None, :] * inv[:, None] - (translation * inv)[:, None] - 0.5)
    x = (sample[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None]).abs() \
        / kernel_scale[:, None, None]
    weights = torch.clamp(1 - x, min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def resized_crop(img: torch.Tensor, box: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out, out, C]: each image's box mapped onto the
    output square (``out = scale * in + translate``)."""
    b, h, w, c = img.shape
    dt = img.dtype
    ch, cw, y0, x0 = box.unbind(1)
    # a true division: ``out_size / ch`` on a tensor multiplies by the
    # reciprocal, which may round to another float than the JAX quotient
    sy = torch.full_like(ch, out_size) / ch
    sx = torch.full_like(cw, out_size) / cw
    wy = _resample_weights(h, out_size, sy, -y0 * sy).to(dt).float()
    wx = _resample_weights(w, out_size, sx, -x0 * sx).to(dt).float()
    t = torch.bmm(wy.transpose(1, 2), img.float().reshape(b, h, w * c))
    t = t.to(dt).float().reshape(b, out_size, w, c).transpose(2, 3) \
        .reshape(b, out_size * c, w)
    out = torch.bmm(t, wx)                                # [B, out*C, out]
    return out.to(dt).reshape(b, out_size, c, out_size).transpose(2, 3)


def _k(value: float, like: torch.Tensor) -> torch.Tensor:
    """A constant in ``like``'s dtype, as a JAX weak-typed Python scalar
    becomes one (bf16 images multiply by bf16(0.299), not by 0.299); a
    CPU 0-d tensor, which torch takes as a scalar on any device."""
    return torch.tensor(value, dtype=like.dtype)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return (_k(0.299, img) * img[..., 0] + _k(0.587, img) * img[..., 1]
            + _k(0.114, img) * img[..., 2])


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def adjust_hue(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Hue rotation in YIQ space by ``factor`` [B] turns (in img's dtype)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]

    def k(v):
        return _k(v, img)

    y = _gray(img)
    i = k(0.596) * r - k(0.274) * g - k(0.322) * b
    q = k(0.211) * r - k(0.523) * g + k(0.312) * b
    angle = factor * k(2.0) * k(math.pi)
    cos, sin = angle.cos()[:, None, None], angle.sin()[:, None, None]
    i2 = cos * i - sin * q
    q2 = sin * i + cos * q
    out = torch.stack([y + k(0.956) * i2 + k(0.621) * q2,
                       y - k(0.272) * i2 - k(0.647) * q2,
                       y - k(1.106) * i2 + k(1.703) * q2], dim=-1)
    return out.clamp(0.0, 1.0)


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, saturation, then hue, each factor rounded to
    img's dtype; the contrast mean reduced in f32 even for bf16 images."""
    dt = img.dtype
    fb, fc, fs, fh = factors.to(dt).unbind(1)
    img = (img * _per_image(fb)).clamp(0.0, 1.0)
    mean = _per_image(_gray(img).float().mean(dim=(1, 2)).to(dt))
    img = (mean + (img - mean) * _per_image(fc)).clamp(0.0, 1.0)
    gray = _gray(img)[..., None]
    img = (gray + (img - gray) * _per_image(fs)).clamp(0.0, 1.0)
    return adjust_hue(img, fh)


def grayscale(img: torch.Tensor) -> torch.Tensor:
    return _gray(img)[..., None].expand_as(img)


def _blur_band(k1d: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """[B, n, n + 2r] banded matrices with ``M[b, i, i + j] = k1d[b, j]``:
    one separable blur pass as a product."""
    dev = k1d.device
    off = (torch.arange(n + 2 * r, device=dev)[None, :]
           - torch.arange(n, device=dev)[:, None])
    inb = (off >= 0) & (off <= 2 * r)
    taps = k1d[:, off.clamp(0, 2 * r)]                   # [B, n, n + 2r]
    return torch.where(inb, taps, 0.0)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Per-image Gaussian blur with reflect-101 borders, rows then
    columns, each pass summed in f32 and rounded to img's dtype."""
    b, h, w, c = img.shape
    dt = img.dtype
    r = BLUR_KERNEL // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k1d = torch.exp(-0.5 * (xs[None, :] / sigma[:, None]) ** 2)
    k1d = k1d / k1d.sum(dim=1, keepdim=True)
    padded = F.pad(img.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect") \
        .permute(0, 2, 3, 1)                             # [B, h+2r, w+2r, C]
    bh = _blur_band(k1d, h, r).to(dt).float()
    rows = torch.bmm(bh, padded.float().reshape(b, h + 2 * r,
                                                (w + 2 * r) * c))
    rows = rows.to(dt).float().reshape(b, h, w + 2 * r, c).transpose(2, 3) \
        .reshape(b, h * c, w + 2 * r)
    bw = bh if h == w else _blur_band(k1d, w, r).to(dt).float()
    out = torch.bmm(rows, bw.transpose(1, 2))            # [B, h*C, w]
    return out.to(dt).reshape(b, h, c, w).transpose(2, 3)


def augment_view(images: torch.Tensor, p: ViewParams, out_size: int = 224,
                 compute_dtype: torch.dtype = None) -> torch.Tensor:
    """One view of a batch ``[B, H, W, 3]`` of floats in [0, 1] ->
    ``[B, out, out, 3]`` in ``compute_dtype`` (None: the images' dtype)."""
    img = images if compute_dtype is None else images.to(compute_dtype)
    img = resized_crop(img, p.box, out_size)
    img = torch.where(_per_image(p.flip), img.flip(2), img)
    img = torch.where(_per_image(p.jitter), color_jitter(img, p.factors), img)
    img = torch.where(_per_image(p.gray), grayscale(img), img)
    img = torch.where(_per_image(p.blur), gaussian_blur(img, p.sigma), img)
    return img.clamp(0.0, 1.0).contiguous()


def augment_pair_batch(images: torch.Tensor, u: torch.Tensor,
                       out_size: int = 224, compute_dtype: torch.dtype = None,
                       strength: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two views of a batch from its uniforms ``u [2, B, N_UNIFORMS]``
    (SimCLRDataTransform, dataset_wrapper.py:80-87; ``strength`` is the
    reference's colour-jitter ``s``). Slicing (u along B, images) slices
    the views bitwise."""
    h, w = images.shape[1], images.shape[2]
    u = u.to(images.device)
    return tuple(augment_view(images, view_params(u[v], h, w, strength),
                              out_size, compute_dtype) for v in (0, 1))
