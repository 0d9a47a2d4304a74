"""``ops/depthwise`` on the CPU: its plain versions against the reference's
three separate PPEG convs and its ``F.conv2d`` residual conv
(tests/transmil_reference.py), output and every gradient, at ragged bag
sizes; the planner's bands over every bag size of the cohort; the
wrappers' refusals.

The plain versions make the reference's calls in its order, so they give
its bits; the comparisons at 1e-5 of the largest value hold the wrappers'
shapes, views and gradients to the reference."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

import transmil_reference as ref
from tpumil_torch.ops import depthwise as dw

TOL = 1e-5
LANDMARKS = 256
# SMs of the cards the planner is checked for: H100 SXM, H100 PCIe
SMS = (132, 114)
# (bag size N, width D, heads): ragged sides at small widths, one published
CASES = [(1, 16, 2), (2, 16, 2), (17, 16, 2), (256, 16, 2), (4097, 8, 2),
         (300, 512, 8)]


def _close(got, want):
    got, want = got.detach(), want.detach()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= TOL * scale


def _grid(n):
    side = math.isqrt(n - 1) + 1
    return side, side * side + 1


def _leaves(g, d, heads, taps=33):
    out = {"res": torch.randn(heads, 1, taps, 1, generator=g) / math.sqrt(taps)}
    for name, k in ref.PPEG:
        out[f"{name}.weight"] = torch.randn(d, 1, k, k, generator=g) / k
        out[f"{name}.bias"] = 0.1 * torch.randn(d, generator=g)
    return {k: v.requires_grad_() for k, v in out.items()}


def _ref_ppeg(x, side, p):
    """The reference's PPEG (transmil_reference.forward, layer 2's head)."""
    d = x.shape[-1]
    g = x[1:].transpose(0, 1).reshape(1, d, side, side)
    conv = {name: F.conv2d(g, p[f"{name}.weight"], p[f"{name}.bias"],
                           padding=size // 2, groups=d)
            for name, size in ref.PPEG}
    g = conv["proj"] + g + conv["proj1"] + conv["proj2"]
    return torch.cat([x[:1], g.reshape(d, -1).transpose(0, 1)], dim=0)


def _ref_residual(v, w, keep):
    """The reference's residual conv (transmil_reference.nystrom): the whole
    length, then its last ``keep`` rows, heads merged."""
    heads, big, _ = v.shape
    out = F.conv2d(v[None], w, padding=(w.shape[2] // 2, 0), groups=heads)[0]
    return out.transpose(0, 1).reshape(big, -1)[-keep:]


def _grads(out, inputs, seed):
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    return torch.autograd.grad((out * dy).sum(), inputs)


@pytest.mark.parametrize("n,d,heads", CASES)
def test_plain_versions_match_the_reference(n, d, heads):
    side, t = _grid(n)
    big = LANDMARKS * -(-t // LANDMARKS)
    g = torch.Generator().manual_seed(n)
    p = _leaves(g, d, heads)
    # v as the model makes it: a head-split view of the qkv projection
    qkv = torch.randn(big, 3 * d, generator=g).requires_grad_()
    v = qkv.view(big, 3, heads, -1).permute(1, 2, 0, 3)[2]
    got = dw.residual_conv(v, p["res"], t)
    want = _ref_residual(v, p["res"], t)
    assert got.shape == (t, d) and _close(got, want)
    for a, b in zip(_grads(got, [qkv, p["res"]], 1),
                    _grads(want, [qkv, p["res"]], 1)):
        assert _close(a, b)

    x = torch.randn(t, d, generator=g).requires_grad_()
    convs = [p[f"{name}.{kind}"] for name, _ in ref.PPEG
             for kind in ("weight", "bias")]
    got = dw.ppeg(x, side, *convs)
    want = _ref_ppeg(x, side, p)
    assert got.shape == (t, d) and _close(got, want)
    assert torch.equal(got[0], x[0])
    for a, b in zip(_grads(got, [x, *convs], 2),
                    _grads(want, [x, *convs], 2)):
        assert _close(a, b)


@pytest.mark.parametrize("n", [17, 300])
def test_plain_versions_give_the_references_bits(n):
    """On the CPU the model runs the plain versions: the reference's calls,
    so its bits, output and gradients. Only the PPEG's input gradient may
    differ in the last bit: autograd sums its four branches in the order
    they were made, the model's convs between its adds, the reference's
    before them."""
    side, t = _grid(n)
    big = LANDMARKS * -(-t // LANDMARKS)
    g = torch.Generator().manual_seed(n)
    p = _leaves(g, 16, 2)
    qkv = torch.randn(big, 48, generator=g).requires_grad_()
    v = qkv.view(big, 3, 2, -1).permute(1, 2, 0, 3)[2]
    got = dw.residual_conv_plain(v, p["res"], t)
    want = _ref_residual(v, p["res"], t)
    assert torch.equal(got, want)
    for a, b in zip(_grads(got, [qkv, p["res"]], 1),
                    _grads(want, [qkv, p["res"]], 1)):
        assert torch.equal(a, b)
    x = torch.randn(t, 16, generator=g).requires_grad_()
    convs = [p[f"{name}.{kind}"] for name, _ in ref.PPEG
             for kind in ("weight", "bias")]
    got, want = dw.ppeg_plain(x, side, *convs), _ref_ppeg(x, side, p)
    assert torch.equal(got, want)
    (dx, *grads), (dx_ref, *grads_ref) = (_grads(got, [x, *convs], 2),
                                          _grads(want, [x, *convs], 2))
    assert _close(dx, dx_ref)
    for a, b in zip(grads, grads_ref):
        assert torch.equal(a, b)


def _check_plan(rows, cols, taps, channels, sms, cw):
    pl = dw.plan(rows, cols, taps, channels, sms, cw)
    kh = taps[0]
    assert pl.band % kh == 0 and pl.band >= kh
    # bands [z band, min((z + 1) band, rows)) for z < bands: contiguous,
    # none empty, the last ending at rows, so every row exactly once
    assert (pl.bands - 1) * pl.band < rows <= pl.bands * pl.band
    assert pl.cb * pl.bc <= dw.CTA_THREADS and channels == pl.chunks * pl.cb
    assert (pl.strips - 1) * pl.bc * cw < cols <= pl.strips * pl.bc * cw
    assert max(pl.strips, pl.bands) <= dw.MAX_GRID_YZ
    ctas = pl.chunks * pl.strips * pl.bands
    # the card is filled, or no band could be shorter
    assert ctas >= sms or pl.band == kh
    # and not more than twice the bands it aims for
    want = -(-sms * dw.CTAS_PER_SM[taps] // (pl.chunks * pl.strips))
    assert pl.bands <= 2 * max(1, want)
    return pl


@pytest.mark.parametrize("sms", SMS)
def test_planner_bands_cover_every_row_once_for_every_bag_size(sms):
    """Every launch of a TransMIL step at every bag size 256..65536 of the
    cohort: the residual conv's forward (T rows) and input gradient (P
    rows), the PPEG's three (side rows of side)."""
    seen = set()
    for n in range(256, 65537):
        side, t = _grid(n)
        if (side, t) in seen:
            continue
        seen.add((side, t))
        big = LANDMARKS * -(-t // LANDMARKS)
        for rows in (t, big):
            _check_plan(rows, 1, (33, 1), 512, sms, 1)
        for cw in dw.COLUMNS[(7, 7)]:
            pl = _check_plan(side, side, (7, 7), 512, sms, cw)
            assert 1 <= dw.reduce_lanes(pl.parts) <= 32
    assert len(seen) == 256 - 16 + 1  # sides 16..256: the shapes of a step
    # at the ends, the rows enumerated
    for rows, cols, taps in ((257, 1, (33, 1)), (512, 1, (33, 1)),
                             (65537, 1, (33, 1)), (65792, 1, (33, 1)),
                             (16, 16, (7, 7)), (256, 256, (7, 7))):
        pl = dw.plan(rows, cols, taps, 512, sms)
        hits = torch.zeros(rows, dtype=torch.int32)
        for z in range(pl.bands):
            hits[z * pl.band:min((z + 1) * pl.band, rows)] += 1
        assert bool((hits == 1).all())


def test_wrappers_refuse_what_they_cannot_take():
    v = torch.zeros(2, 40, 8)
    with pytest.raises(ValueError, match="KH, 1"):
        dw.residual_conv(v, torch.zeros(3, 1, 33, 1), 10)
    with pytest.raises(ValueError, match="keep"):
        dw.residual_conv(v, torch.zeros(2, 1, 33, 1), 41)
    with pytest.raises(ValueError, match="unsupported device meta"):
        dw.residual_conv(v.to("meta"), torch.zeros(2, 1, 33, 1,
                                                   device="meta"), 10)
    x = torch.zeros(10, 4)
    convs = [torch.zeros(4, 1, k, k) if i % 2 == 0 else torch.zeros(4)
             for k in (7, 5, 3) for i in range(2)]
    with pytest.raises(ValueError, match="grid"):
        dw.ppeg(x, 4, *convs)
    with pytest.raises(ValueError, match="weights"):
        dw.ppeg(x, 3, *convs[:-1], torch.zeros(5))
    with pytest.raises(ValueError, match="channels"):
        dw.plan(100, 1, (33, 1), 200, 132)
    with pytest.raises(KeyError):
        dw.plan(100, 1, (31, 1), 512, 132)
    assert dw.plan(100, 1, (33, 1), 96, 132).cb == 32
    assert [dw.reduce_lanes(t) for t in (1, 16, 17, 105, 182, 1000)] == [
        1, 1, 2, 8, 16, 32]
