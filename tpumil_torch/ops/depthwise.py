"""TransMIL's depthwise convolutions as one operation: a depthwise conv over a
channels-last grid ``[rows, cols, C]`` (the channel the innermost,
contiguous axis), with same padding and a weight per channel or per group
of channels.

  * ``residual_conv(v, weight, keep)``: Nystrom attention's residual conv.
    ``v [H, P, C / H]`` is a head-split view whose heads lie side by side in
    memory (``v.stride(0) == C / H``, as the qkv projection's ``[P, 3, H, C
    / H]`` output gives them), read as a P x 1 grid of C channels; the
    ``(KH, 1)`` taps of ``weight [H, 1, KH, 1]`` are shared by a head's
    channels. Returns the last ``keep`` rows, heads merged: ``[keep, C]``.
  * ``ppeg(x, side, w7, b7, w5, b5, w3, b3)``: the PPEG. ``x [1 + side^2,
    C]`` is the cls row and the grid, row-major; returns ``x[0]`` and
    ``dw7(G) + G + dw5(G) + dw3(G)``. Its backward is one 7x7 conv whose
    weight is ``w7 + pad(w5) + pad(w3) + delta`` (delta: 1 at the centre
    tap): the gradient of the merged weight is ``w7``'s, its centre 5x5
    and 3x3 crops are ``w5``'s and ``w3``'s, and the three biases take the
    same one.

On a CPU tensor each runs its plain version (``*_plain``: the model's
``F.conv2d`` calls on the NCHW view, in its order); on a CUDA tensor it
launches ``csrc/depthwise.cu`` or raises: the forward, the input gradient
and the weight gradient (the PPEG's as partials and their fixed-order
merge). The passes that the plain version runs on ATen's kernels in one
order (both forwards, the residual conv's input and weight gradients) give
ATen's bits there; the PPEG's backward runs the merged 7x7 (the note in the
source says why). Only the taps (33, 1) and (7, 7), and 64 channels a head,
are built. :func:`plan` picks each launch's rows per CTA from the shape
and the card's SM count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CTA_THREADS = 128    # csrc/depthwise.cu's kThreads
# the CTAs per SM the planner aims for, by taps: the best of 1-8 on an H100
# (PERF.md); the 7x7 kernel's 7-row halo favours one long band a column
CTAS_PER_SM = {(33, 1): 2, (7, 7): 1}
# the taps built, and the columns a thread computes for each: (forward,
# input gradient, weight gradient), as csrc/depthwise.cu instantiates them
COLUMNS = {(33, 1): (1, 1, 1), (7, 7): (2, 4, 2)}
MAX_GRID_YZ = 65535
MAX_FLOATS = 2 ** 31 - 1  # the kernels' offsets are 32-bit


# -- plain PyTorch versions --------------------------------------------------

def residual_conv_plain(v: torch.Tensor, weight: torch.Tensor,
                        keep: int) -> torch.Tensor:
    """``F.conv2d`` on ``v[None]`` (NCHW, one head a channel), its last
    ``keep`` rows, heads merged: ``[keep, C]``."""
    heads, rows, _ = v.shape
    out = F.conv2d(v[None], weight, padding=(weight.shape[2] // 2, 0),
                   groups=heads)[0, :, rows - keep:]
    return out.transpose(0, 1).reshape(keep, -1)


def ppeg_plain(x: torch.Tensor, side: int, w7, b7, w5, b5, w3,
               b3) -> torch.Tensor:
    """The model's three ``F.conv2d`` calls on the grid's NCHW view, summed
    as ``((dw7(G) + G) + dw5(G)) + dw3(G)``, the cls row put back in
    front."""
    d = x.shape[-1]
    g = x[1:].transpose(0, 1).view(1, d, side, side)
    g = (F.conv2d(g, w7, b7, padding=w7.shape[-1] // 2, groups=d) + g
         + F.conv2d(g, w5, b5, padding=w5.shape[-1] // 2, groups=d)
         + F.conv2d(g, w3, b3, padding=w3.shape[-1] // 2, groups=d))
    return torch.cat([x[:1], g.flatten(2)[0].transpose(0, 1)])


# -- the planner ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``dw_band_kernel``: CTAs of ``cb`` channels x ``bc``
    threads across (``bc`` x the columns a thread computes) x ``band``
    rows; the grid is ``(chunks, strips, bands)``."""

    band: int
    cb: int
    bc: int
    chunks: int
    strips: int
    bands: int

    @property
    def parts(self) -> int:
        """The weight gradient's partials per segment of channels."""
        return self.strips * self.bands


def plan(rows: int, cols: int, taps: Tuple[int, int], channels: int,
         sms: int, cw: int = 1) -> Plan:
    """The rows per CTA for ``rows`` rows walked over a ``cols``-wide grid
    of ``channels`` (a multiple of 32), each thread on ``cw`` adjacent
    columns: a warp on 32 consecutive channels (128 a CTA where the grid is
    one column wide, else 32 channels x 4 threads across), and bands a
    multiple of the KH-step ring, short enough to put ``CTAS_PER_SM`` CTAs
    on each of the card's ``sms`` SMs (at most twice that), and never
    shorter than KH."""
    kh = taps[0]
    if rows < 1 or cols < 1 or channels < 1:
        raise ValueError(f"an empty grid: {rows} x {cols} x {channels}")
    if channels % 32:
        raise ValueError(f"{channels} channels: the kernel takes a multiple "
                         f"of 32")
    cb = CTA_THREADS if cols == 1 and channels % CTA_THREADS == 0 else 32
    bc = 1 if cols == 1 else CTA_THREADS // cb
    chunks, strips = channels // cb, -(-cols // (bc * cw))
    want = max(1, -(-sms * CTAS_PER_SM[tuple(taps)] // (chunks * strips)))
    band = kh * max(1, rows // (want * kh))
    bands = -(-rows // band)
    if strips > MAX_GRID_YZ or bands > MAX_GRID_YZ:
        raise ValueError(f"a {rows} x {cols} grid is too large for one launch")
    return Plan(band, cb, bc, chunks, strips, bands)


def reduce_lanes(terms: int) -> int:
    """Threads that sum one output of the PPEG's weight gradient: a power
    of two up to 32, each taking at most ~16 of the ``terms`` partials."""
    lanes = 1
    while lanes < 32 and lanes * 16 < terms:
        lanes *= 2
    return lanes


# -- the kernels ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Site:
    """A grid in x's memory: ``rows x cols x channels`` at ``offset``
    floats, with row and column pitches ``pitch``; ``lead`` rows of
    ``channels`` before it pass through; the output is the last ``keep``
    rows, contiguous ``[lead + keep * cols, channels]``."""

    rows: int
    cols: int
    channels: int
    taps: Tuple[int, int]
    group: int
    keep: int
    lead: int
    offset: int
    pitch: Tuple[int, int]
    heads: int  # x is [heads, rows, channels / heads] (residual conv) or 0


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor], floats: int = 0):
    return None if t is None else t.data_ptr() + 4 * floats


def _launch_band(mode: int, s: _Site, src, src_off, src_rows, src_pitch,
                 dy, dst, dst_off, rows, weights, biases, delta: bool,
                 part=None, has_bias: bool = False) -> None:
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    kh, kw = s.taps
    cw = COLUMNS[s.taps][mode]
    p = plan(rows, s.cols, s.taps, s.channels, _sms(src.device), cw)
    (w0, w1, w2), (b0, b1, b2) = weights, biases
    k1 = 0 if w1 is None else w1.shape[-1]
    k2 = 0 if w2 is None else w2.shape[-1]
    shift = s.keep - s.rows if mode == 1 else s.rows - s.keep
    out_pitch = (s.cols * s.channels, s.channels)
    lead = s.lead * s.channels
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.tpumil_depthwise_band(
            mode, kh, kw, cw, _ptr(src, src_off), src_rows, *src_pitch,
            _ptr(dy, lead), _ptr(dst, dst_off), rows, *out_pitch, s.cols,
            s.channels, s.group, shift, _ptr(w0), _ptr(w1), k1, _ptr(w2), k2,
            int(delta), _ptr(b0), _ptr(b1), _ptr(b2), _ptr(src), _ptr(dst),
            0 if mode == 2 else lead, p.band, p.cb, p.bc, _ptr(part),
            int(has_bias), stream)
    if err != 0:
        raise RuntimeError(f"depthwise kernel (mode {mode}) launch failed: "
                           f"CUDA error {err}")


def _forward(s: _Site, x, weights, biases, delta) -> torch.Tensor:
    out = torch.empty((s.lead + s.keep * s.cols, s.channels),
                      device=x.device)
    _launch_band(0, s, x, s.offset, s.rows, s.pitch, None, out,
                 s.lead * s.channels, s.keep, weights, biases, delta)
    return out


def _input_grad(s: _Site, dy, weights, delta) -> torch.Tensor:
    dx = torch.empty((s.lead + s.rows * s.cols, s.channels), device=dy.device)
    off = s.lead * s.channels
    _launch_band(1, s, dy, off, s.keep, (s.cols * s.channels, s.channels),
                 None, dx, off, s.rows, weights, (None,) * 3, delta)
    if s.heads:
        return dx.view(s.rows, s.heads, -1).permute(1, 0, 2)
    return dx


def _weight_grad(s: _Site, x, dy, weights, biases):
    """``([dw0, dw1, dw2, db0, db1, db2], launches)``, None where the leaf
    is absent: the residual conv's in ATen's order (one kernel), the
    PPEG's as partials and their fixed-order merge (two)."""
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    kh, kw = s.taps
    grads = [None if w is None else torch.empty_like(w) for w in weights]
    grads += [None if b is None else torch.empty_like(b) for b in biases]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if s.cols == 1:
            err = lib.tpumil_depthwise_rows_wgrad(
                x.data_ptr(), s.rows, s.pitch[0], dy.data_ptr(), s.keep,
                s.channels, s.heads, kh, s.rows - s.keep, grads[0].data_ptr(),
                stream)
            launches = 1
        else:
            p = plan(s.keep, s.cols, s.taps, s.channels, _sms(x.device),
                     COLUMNS[s.taps][2])
            has_bias = biases[0] is not None
            part = torch.empty((p.parts * s.channels * (kh * kw + has_bias),),
                               device=x.device)
            _launch_band(2, s, x, s.offset, s.rows, s.pitch, dy, None, 0,
                         s.keep, weights, biases, False, part, has_bias)
            err = lib.tpumil_depthwise_reduce(
                part.data_ptr(), p.parts, s.channels, kh, kw, int(has_bias),
                reduce_lanes(p.parts), _ptr(grads[0]), _ptr(grads[1]),
                0 if grads[1] is None else weights[1].shape[-1],
                _ptr(grads[2]), 0 if grads[2] is None else weights[2].shape[-1],
                _ptr(grads[3]), _ptr(grads[4]), _ptr(grads[5]), stream)
            launches = 2
    if err != 0:
        raise RuntimeError(f"depthwise weight-gradient launch failed: CUDA "
                           f"error {err}")
    return grads, launches


def _check_size(name: str, s: _Site) -> None:
    if max(s.rows * s.pitch[0], (s.lead + s.rows * s.cols) * s.channels) \
            > MAX_FLOATS:
        raise ValueError(f"{name}: a {s.rows} x {s.cols} x {s.channels} grid "
                         f"is too large for the kernels' 32-bit offsets")


class _Depthwise(torch.autograd.Function):
    """The card's forward and backward of one site (``_Site``)."""

    @staticmethod
    def forward(ctx, x, site, delta, counter, w0, w1, w2, b0, b1, b2):
        weights, biases = (w0, w1, w2), (b0, b1, b2)
        ctx.site, ctx.delta, ctx.counter = site, delta, counter
        ctx.save_for_backward(x, *weights, *biases)
        counter.launches += 1
        return _forward(site, x, weights, biases, delta)

    @staticmethod
    def backward(ctx, dy):
        x, w0, w1, w2, b0, b1, b2 = ctx.saved_tensors
        s, weights, biases = ctx.site, (w0, w1, w2), (b0, b1, b2)
        dy = dy.contiguous()
        if dy.data_ptr() % 16:  # the weight gradient reads 16-byte rows
            dy = dy.clone()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(s, dy, weights, ctx.delta)
            ctx.counter.launches += 1
        grads = [None] * 6
        if any(ctx.needs_input_grad[4:]):
            grads, launches = _weight_grad(s, x, dy, weights, biases)
            ctx.counter.launches += launches
        return (dx, None, None, None, *grads)


def _check_cuda(name: str, x: torch.Tensor, *params) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in (x, *params):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} computes in float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in params:
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")


def residual_conv(v: torch.Tensor, weight: torch.Tensor,
                  keep: int) -> torch.Tensor:
    """The depthwise ``(KH, 1)`` conv of ``v [H, P, C / H]`` (one weight a
    head, zero padding KH // 2), its last ``keep`` rows, heads merged:
    ``[keep, C]``."""
    heads, rows, dh = v.shape
    if tuple(weight.shape[:2]) != (heads, 1) or weight.shape[3] != 1:
        raise ValueError(f"expected a [{heads}, 1, KH, 1] weight, got "
                         f"{tuple(weight.shape)}")
    if not 0 < keep <= rows:
        raise ValueError(f"keep={keep} outside 1..{rows}")
    if v.device.type == "cpu":
        return residual_conv_plain(v, weight, keep)
    _check_cuda("residual_conv", v, weight)
    taps = (weight.shape[2], 1)
    if taps not in COLUMNS:
        raise ValueError(f"taps {taps}: the kernel is built for "
                         f"{list(COLUMNS)}")
    if v.stride(2) != 1 or v.stride(0) != dh:
        raise ValueError(f"v's heads must lie side by side with contiguous "
                         f"channels, got strides {v.stride()}")
    if dh != 64:
        raise ValueError(f"{dh} channels a head: the weight-gradient kernel "
                         f"takes 64")
    if v.data_ptr() % 16 or v.stride(1) % 4:
        raise ValueError("v's rows must start on 16-byte boundaries")
    site = _Site(rows, 1, heads * dh, taps, dh, keep, 0, 0,
                 (v.stride(1), 0), heads)
    _check_size("residual_conv", site)
    return _Depthwise.apply(v, site, False, residual_conv, weight, None, None,
                            None, None, None)


def ppeg(x: torch.Tensor, side: int, w7, b7, w5, b5, w3,
         b3) -> torch.Tensor:
    """``[x[0]; dw7(G) + G + dw5(G) + dw3(G)]`` for the grid ``G = x[1:]``
    (``side x side`` rows, row-major); on the card, a backward of one
    merged 7x7 depthwise conv."""
    t, d = x.shape
    if t != side * side + 1:
        raise ValueError(f"{t} rows is not a cls row and a {side}^2 grid")
    convs = ((w7, b7), (w5, b5), (w3, b3))
    for w, b in convs:
        k = w.shape[-1]
        if tuple(w.shape) != (d, 1, k, k) or tuple(b.shape) != (d,):
            raise ValueError(f"expected [{d}, 1, k, k] weights and [{d}] "
                             f"biases, got {tuple(w.shape)}, {tuple(b.shape)}")
    if x.device.type == "cpu":
        return ppeg_plain(x, side, w7, b7, w5, b5, w3, b3)
    _check_cuda("ppeg", x, w7, b7, w5, b5, w3, b3)
    taps = (w7.shape[-1],) * 2
    if taps not in COLUMNS:
        raise ValueError(f"taps {taps}: the kernel is built for "
                         f"{list(COLUMNS)}")
    if x.stride() != (d, 1):
        raise ValueError(f"ppeg expects a contiguous [T, C] x, got strides "
                         f"{x.stride()}")
    site = _Site(side, side, d, taps, 1, side, 1, d, (side * d, d), 0)
    _check_size("ppeg", site)
    return _Depthwise.apply(x, site, True, ppeg, w7, w5, w3, b7, b5, b3)


# kernel launches since the last reset (plain ints: the tests zero them and
# read them to show the main path went through the kernels)
residual_conv.launches = 0
ppeg.launches = 0
