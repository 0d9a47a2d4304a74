"""The port's SimCLR ops against the JAX package's: NT-Xent and
l2_normalize (tpumil_torch/ops/nt_xent.py), and the on-device augmentations
(tpumil_torch/ops/augment.py), fed the uniforms that the JAX package draws
from its per-image keys (tests/torch_simclr_util.py).

Bars. NT-Xent: value rtol 1e-6, gradient rtol 1e-5. Augmentations, given
the same parameters: f32 atol 1e-5; bf16 within two bf16 steps of [0.5, 1)
(2 * 2^-8), the largest values a view holds. The map from uniforms to the
crop box agrees to 2 f32 ulps, not bitwise: XLA's f32 ``exp`` is not
correctly rounded (it differs from a correctly rounded exp in ~7% of
arguments; torch's in ~1%), and a 1-ulp shift of a crop box moves a view of
white noise by up to ~5e-5, so the end-to-end comparison through the port's
own map holds 1e-4 at 224^2 (the same views from the same boxes hold 1e-5).
The distributions are held to the torchvision-like oracles of
tests/test_simclr.py, with seeded binomial bounds on the coins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_simclr import _np_gray, _tv_color_jitter, _tv_rrc_params
from torch_simclr_util import jax_uniforms, pair_uniforms
from tpumil.ops import augment as ja
from tpumil.ops import nt_xent as jnt
from tpumil_torch.ops import augment as ta
from tpumil_torch.ops import nt_xent as tnt

F32_ATOL = 1e-5
BF16_ATOL = 2 * 2 ** -8
ULP2 = 2.4e-7  # >= 2 f32 ulps relative to any value


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("cosine", [True, False])
def test_nt_xent_value_and_gradient_match_jax(cosine):
    rng = np.random.default_rng(0)
    zis, zjs = (rng.standard_normal((16, 8)).astype(np.float32)
                for _ in range(2))
    want, (gi, gj) = jax.value_and_grad(
        lambda a, b: jnt.nt_xent_loss(a, b, 0.5, cosine), argnums=(0, 1))(
        jnp.asarray(zis), jnp.asarray(zjs))
    ti = torch.from_numpy(zis).requires_grad_()
    tj = torch.from_numpy(zjs).requires_grad_()
    got = tnt.nt_xent_loss(ti, tj, 0.5, cosine)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-7)


def test_l2_normalize_matches_jax_and_has_a_finite_gradient_at_zero():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((6, 5)).astype(np.float32)
    z[2] = 0.0  # an all-zero projection (IN over a 1x1 map gives these)
    want, vjp = jax.vjp(jnt.l2_normalize, jnp.asarray(z))
    (gw,) = vjp(jnp.ones_like(want))
    t = torch.from_numpy(z).requires_grad_()
    got = tnt.l2_normalize(t)
    got.backward(torch.ones_like(got))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-7)
    # the loss through a zero row: finite value and gradient
    zz = torch.zeros(4, 8, requires_grad=True)
    loss = tnt.nt_xent_loss(zz, zz, 0.5)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(zz.grad).all()


@pytest.mark.parametrize("h,w", [(224, 224), (64, 64), (64, 16)])
def test_crop_box_matches_rrc_params(h, w):
    """The first attempt that fits, else the full frame centred (64 x 16
    falls back often); boxes within 2 ulps, the fallback decisions equal."""
    keys = jax.random.split(jax.random.PRNGKey(7), 2000)
    want = np.stack([np.asarray(v) for v in jax.vmap(
        lambda k: ja.rrc_params(jax.random.split(k, 7)[0], h, w))(keys)], 1)
    got = ta.crop_box(jax_uniforms(keys), h, w).numpy()
    # sizes to 2 ulps; origins (u * (w - cw)) to 2 ulps of the side
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=ULP2, atol=0)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0,
                               atol=ULP2 * max(h, w))
    full = (want[:, 0] == h) & (want[:, 1] == w)
    assert np.array_equal(full, (got[:, 0] == h) & (got[:, 1] == w))
    if w != h:
        assert 0 < full.sum() < len(full)


def test_view_params_match_jax_draws():
    """Coins and the jitter and blur draws are the JAX package's, bitwise."""
    keys = jax.random.split(jax.random.PRNGKey(8), 500)
    p = ta.view_params(jax_uniforms(keys), 64, 64, strength=0.5)
    ks = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
    for coin, idx, prob in ((p.flip, 1, 0.5), (p.jitter, 2, 0.8),
                            (p.gray, 4, 0.2), (p.blur, 5, 0.5)):
        want = jax.vmap(lambda k: jax.random.bernoulli(k, prob))(ks[:, idx])
        assert np.array_equal(coin.numpy(), np.asarray(want))
    sigma = jax.vmap(lambda k: jax.random.uniform(k, minval=0.1, maxval=2.0))(
        ks[:, 6])
    assert np.array_equal(p.sigma.numpy(), np.asarray(sigma))
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(ks[:, 3])
    for j, (lo, hi) in enumerate([(0.6, 1.4)] * 3 + [(-0.1, 0.1)]):
        want = jax.vmap(lambda k: jax.random.uniform(k, minval=lo,
                                                     maxval=hi))(sub[:, j])
        assert np.array_equal(p.factors[:, j].numpy(), np.asarray(want))


def _per_image(fn, keys, imgs):
    return np.stack([_np(fn(k, jnp.asarray(im))) for k, im in
                     zip(keys, imgs)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_each_op_matches_jax(dtype):
    """Crop (64^2 -> 48^2 and 64^2), jitter, hue, grayscale and blur on the
    same parameters as the JAX ops."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    rng = np.random.default_rng(2)
    imgs = rng.random((6, 64, 64, 3)).astype(np.float32)
    jimgs = [jnp.asarray(im).astype(jdt) for im in imgs]
    timgs = torch.from_numpy(imgs).to(tdt)
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    sub = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
    p = ta.view_params(jax_uniforms(keys), 64, 64)
    boxes = torch.from_numpy(np.stack([np.asarray(v) for v in jax.vmap(
        lambda k: ja.rrc_params(k, 64, 64))(sub[:, 0])], 1))
    for out in (48, 64):
        want = _per_image(lambda k, im: ja._random_resized_crop(k, im, out),
                          sub[:, 0], jimgs)
        got = ta.resized_crop(timgs, boxes, out)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0)
    want = _per_image(ja._color_jitter, sub[:, 3], jimgs)
    np.testing.assert_allclose(_np(ta.color_jitter(timgs, p.factors)), want,
                               atol=atol, rtol=0)
    hue = p.factors[:, 3].to(tdt)
    want = np.stack([_np(ja._adjust_hue(im, jnp.asarray(float(f)).astype(jdt)))
                     for im, f in zip(jimgs, hue.float())])
    np.testing.assert_allclose(_np(ta.adjust_hue(timgs, hue)), want,
                               atol=atol, rtol=0)
    want = np.stack([_np(jnp.broadcast_to(ja._rgb_to_gray(im), im.shape))
                     for im in jimgs])
    np.testing.assert_allclose(_np(ta.grayscale(timgs)), want, atol=atol,
                               rtol=0)
    want = _per_image(ja._gaussian_blur, sub[:, 6], jimgs)
    np.testing.assert_allclose(_np(ta.gaussian_blur(timgs, p.sigma)), want,
                               atol=atol, rtol=0)


@pytest.mark.parametrize("size,dtype", [(64, "f32"), (64, "bf16"),
                                        (224, "f32")])
def test_augment_pair_batch_matches_jax(size, dtype):
    """Both views of ``augment_pair_batch_keyed`` from the same keys: the
    port's own map and apply, and its apply on JAX's crop boxes."""
    jdt, tdt = {"f32": (None, None), "bf16": (jnp.bfloat16,
                                              torch.bfloat16)}[dtype]
    b = 4 if size == 224 else 8
    imgs = np.random.default_rng(3).random((b, size, size, 3)) \
        .astype(np.float32)
    keys1, keys2 = ja.pair_keys(jax.random.PRNGKey(4), b)
    want = ja.augment_pair_batch_keyed(keys1, keys2, jnp.asarray(imgs), size,
                                       jdt)
    u = pair_uniforms(keys1, keys2)
    got = ta.augment_pair_batch(torch.from_numpy(imgs), u, size, tdt)
    own_atol = {64: F32_ATOL, 224: 1e-4}[size] if dtype == "f32" \
        else BF16_ATOL
    for v, keys in enumerate((keys1, keys2)):
        assert got[v].shape == (b, size, size, 3) and got[v].dtype == (
            tdt or torch.float32)
        np.testing.assert_allclose(_np(got[v]), _np(want[v]), atol=own_atol,
                                   rtol=0)
        boxes = np.stack([np.asarray(x) for x in jax.vmap(
            lambda k: ja.rrc_params(jax.random.split(k, 7)[0], size, size))(
            keys)], 1)
        p = ta.view_params(u[v], size, size)._replace(
            box=torch.from_numpy(boxes))
        same = ta.augment_view(torch.from_numpy(imgs), p, size, tdt)
        np.testing.assert_allclose(
            _np(same), _np(want[v]),
            atol=F32_ATOL if dtype == "f32" else BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_microbatch_slice_is_bitwise(dtype):
    """A slice of (uniforms, images) gives bitwise the full batch's views:
    what the grad-cache step relies on."""
    imgs = torch.from_numpy(np.random.default_rng(5).random((8, 48, 48, 3))
                            .astype(np.float32))
    u = ta.draw_uniforms(torch.Generator().manual_seed(0), 8)
    full = ta.augment_pair_batch(imgs, u, 32, dtype)
    for lo, hi in ((0, 2), (2, 6), (7, 8)):
        part = ta.augment_pair_batch(imgs[lo:hi], u[:, lo:hi], 32, dtype)
        for v in (0, 1):
            assert torch.equal(part[v], full[v][lo:hi])


def _binomial_ok(hits, n, p, z=5.0):
    return abs(hits - n * p) <= z * np.sqrt(n * p * (1 - p))


def test_sampler_matches_torchvision_oracles(rng):
    """Crop-box moments against torchvision's get_params over 8192 draws
    (tests/test_simclr.py's bounds) and the four coins' rates within 5
    sigma of p."""
    n, h = 8192, 224
    u = ta.draw_uniforms(torch.Generator().manual_seed(7), n)[0]
    p = ta.view_params(u, h, h)
    ch, cw, y0, x0 = p.box.double().numpy().T
    tv = np.array([_tv_rrc_params(rng, h, h) for _ in range(n)], np.float64)
    ti, tj, tch, tcw = tv.T
    af, taf = ch * cw / h ** 2, tch * tcw / h ** 2
    assert abs(af.mean() - taf.mean()) < 0.015
    assert abs(af.std() - taf.std()) < 0.015
    la, tla = np.log(cw / ch), np.log(tcw / tch)
    assert abs(la.mean() - tla.mean()) < 0.01
    assert abs(la.std() - tla.std()) < 0.02
    sel, tsel = cw < h - 1, tcw < h - 1
    rel, trel = x0[sel] / (h - cw[sel]), tj[tsel] / (h - tcw[tsel])
    assert abs(rel.mean() - trel.mean()) < 0.02
    assert abs(rel.std() - trel.std()) < 0.02
    for coin, prob in ((p.flip, 0.5), (p.jitter, 0.8), (p.gray, 0.2),
                       (p.blur, 0.5)):
        assert _binomial_ok(int(coin.sum()), n, prob), (prob, int(coin.sum()))
    assert 0.1 <= float(p.sigma.min()) and float(p.sigma.max()) < 2.0


def test_color_jitter_moments_match_torchvision(rng):
    """The fixed-order YIQ-hue jitter against torchvision's random-order
    HSV-hue composition over 1500 draws (tests/test_simclr.py's bounds)."""
    img = (rng.random((48, 48, 3)) * 0.7 + 0.15).astype(np.float32)
    n = 1500
    p = ta.view_params(ta.draw_uniforms(torch.Generator().manual_seed(3),
                                        n)[0], 48, 48)
    ours = ta.color_jitter(torch.from_numpy(img).expand(n, -1, -1, -1),
                           p.factors).numpy()
    tv = np.stack([_tv_color_jitter(rng, img.astype(np.float64))
                   for _ in range(n)])
    for ch in range(3):
        assert abs(ours[..., ch].mean() - tv[..., ch].mean()) < 0.025
        assert abs(ours[..., ch].std() - tv[..., ch].std()) < 0.025


def test_full_pipeline_channel_moments(rng):
    """Channel mean/std of 1024 views against a numpy oracle of the
    torchvision pipeline (tests/test_simclr.py::test_full_pipeline_channel_
    moments' oracle and bounds)."""
    from PIL import Image

    base = (rng.random((8, 64, 64, 3)) * 0.8 + 0.1).astype(np.float32)
    out = 32
    gen = torch.Generator().manual_seed(11)
    views = []
    for _ in range(64):
        views += [v.numpy() for v in ta.augment_pair_batch(
            torch.from_numpy(base), ta.draw_uniforms(gen, 8), out)]
    ours = np.concatenate(views)

    def oracle_view(img):
        i, j, ch, cw = _tv_rrc_params(rng, 64, 64)
        pil = Image.fromarray((img[i:i + ch, j:j + cw] * 255).astype(np.uint8))
        v = np.asarray(pil.resize((out, out), Image.BILINEAR),
                       np.float64) / 255.0
        if rng.random() < 0.5:
            v = v[:, ::-1]
        if rng.random() < 0.8:
            v = _tv_color_jitter(rng, v)
        if rng.random() < 0.2:
            v = np.repeat(_np_gray(v)[..., None], 3, -1)
        if rng.random() < 0.5:
            sigma = rng.uniform(0.1, 2.0)
            r = 13 // 2
            xs = np.arange(-r, r + 1, dtype=np.float64)
            k1d = np.exp(-0.5 * (xs / sigma) ** 2)
            k1d /= k1d.sum()
            pad = np.pad(v, ((r, r), (r, r), (0, 0)), mode="reflect")
            conv = lambda a: np.convolve(a, k1d, "valid")  # noqa: E731
            v = np.apply_along_axis(conv, 1, np.apply_along_axis(conv, 0, pad))
        return np.clip(v, 0, 1)

    tv = np.stack([oracle_view(base[b].astype(np.float64))
                   for _ in range(128) for b in range(8)])
    assert abs(ours.mean() - tv.mean()) < 0.02
    assert abs(ours.std() - tv.std()) < 0.03
    for ch in range(3):
        assert abs(ours[..., ch].mean() - tv[..., ch].mean()) < 0.025
