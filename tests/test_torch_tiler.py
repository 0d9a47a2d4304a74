"""The slide front end of the port against the JAX package, host only:
slide readers, DeepZoom tiles (overlap 0, 1 and 8), the magnification plan,
the background filter, the tiler in both layouts, crop_single and the HSV
helpers, on synthetic pyramidal TIFFs written here with PIL. Tiles must be
pixel-equal; JPEGs the tiler wrote must decode to the same pixels.
"""

import argparse
import glob
import os

import numpy as np
import pytest

from tpumil.cli import crop_single as jax_crop_cli
from tpumil.cli import tiler as jax_tiler_cli
from tpumil.data import slide as jslide
from tpumil.data import tiler as jtiler
from tpumil.ops import image as jimage
from tpumil_torch.cli import crop_single as crop_cli
from tpumil_torch.cli import tiler as tiler_cli
from tpumil_torch.data import slide, tiler
from tpumil_torch.ops import image
from tpumil_torch.utils import native


def _synthetic(rng, w, h, tissue=0.5):
    """White background with a textured 'tissue' block at the top left."""
    img = np.full((h, w, 3), 255, np.uint8)
    tw, th = int(w * tissue), int(h * tissue)
    img[:th, :tw] = (rng.random((th, tw, 3)) * 200 + 20).astype(np.uint8)
    return img


def _pyramid_tiff(img, path, levels=3, mag=20):
    from PIL import Image

    pages = [Image.fromarray(img)]
    for _ in range(levels - 1):
        prev = pages[-1]
        pages.append(prev.resize((max(1, prev.width // 2),
                                  max(1, prev.height // 2))))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pages[0].save(path, save_all=True, append_images=pages[1:],
                  description=f"Aperio Fake |AppMag = {mag}|")
    return path


def _decoded(root):
    """{relative path: decoded pixels} of every image file under root."""
    from PIL import Image

    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*.*"),
                              recursive=True)):
        with Image.open(p) as im:
            out[os.path.relpath(p, root)] = np.asarray(im.convert("RGB"))
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _decoded(got_root), _decoded(want_root)
    assert sorted(got) == sorted(want) and got
    for rel in got:
        np.testing.assert_array_equal(got[rel], want[rel], err_msg=rel)


def test_backends_match_jax(tmp_path, rng):
    img = _synthetic(rng, 450, 300, tissue=1.0)
    path = _pyramid_tiff(img, str(tmp_path / "s.tif"))
    reads = [((0, 0), 0, (64, 48)), ((400, 280), 0, (64, 64)),
             ((-10, -5), 0, (32, 32)), ((128, 64), 1, (40, 30)),
             ((300, 200), 2, (50, 50))]
    for ours, theirs in ((slide.TiffBackend(path), jslide.TiffBackend(path)),
                         (slide.ImageBackend(img), jslide.ImageBackend(img))):
        assert ours.level_dimensions == theirs.level_dimensions
        assert ours.properties == theirs.properties
        assert ours.objective_power(40) == theirs.objective_power(40)
        for lv in range(ours.level_count):
            assert ours.level_downsample(lv) == theirs.level_downsample(lv)
        for ds in (1, 2, 3, 4, 8):
            assert (ours.best_level_for_downsample(ds)
                    == theirs.best_level_for_downsample(ds))
        for loc, lv, size in reads:
            if lv < ours.level_count:
                np.testing.assert_array_equal(ours.read_region(loc, lv, size),
                                              theirs.read_region(loc, lv, size))
        ours.close()
        theirs.close()
    assert slide.TiffBackend(path).objective_power(40) == 20.0
    for desc in ("Aperio |AppMag = 40|x", "no mag", "AppMag", None):
        assert (slide.parse_objective_power(desc)
                == jslide.parse_objective_power(desc))


def test_open_slide_falls_through_as_jax(tmp_path, rng):
    from PIL import Image

    img = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    png = str(tmp_path / "x.png")
    Image.fromarray(img).save(png)
    tif = _pyramid_tiff(img, str(tmp_path / "x.tif"), levels=2)
    for path in (png, tif):
        ours, theirs = slide.open_slide(path), jslide.open_slide(path)
        assert type(ours).__name__ == type(theirs).__name__
        np.testing.assert_array_equal(ours.read_region((3, 5), 0, (20, 30)),
                                      theirs.read_region((3, 5), 0, (20, 30)))


@pytest.mark.parametrize("overlap", [0, 1, 8])
@pytest.mark.parametrize("backend", ["tiff", "image"])
def test_deepzoom_tiles_match_jax(tmp_path, rng, overlap, backend):
    """Every tile of the top three deep-zoom levels, pixel-equal: the top
    level reads unscaled, the lower ones land on pyramid levels (tiff) or
    go through the LANCZOS resize (image)."""
    img = _synthetic(rng, 450, 300, tissue=1.0)
    if backend == "tiff":
        path = _pyramid_tiff(img, str(tmp_path / "s.tif"))
        ours, theirs = slide.TiffBackend(path), jslide.TiffBackend(path)
    else:
        ours, theirs = slide.ImageBackend(img), jslide.ImageBackend(img)
    dz, jdz = slide.DeepZoom(ours, 64, overlap), jslide.DeepZoom(theirs, 64,
                                                                 overlap)
    assert dz.level_dimensions_dz == jdz.level_dimensions_dz
    assert dz.level_count == jdz.level_count == 10
    for level in range(dz.level_count - 3, dz.level_count):
        assert dz.level_tiles(level) == jdz.level_tiles(level)
        cols, rows = dz.level_tiles(level)
        for row in range(rows):
            for col in range(cols):
                got = dz.get_tile(level, (col, row))
                np.testing.assert_array_equal(
                    got, jdz.get_tile(level, (col, row)),
                    err_msg=f"level {level} tile {col}_{row}")
    top = dz.get_tile(dz.level_count - 1, (1, 1))
    assert top.shape == (64 + 2 * overlap, 64 + 2 * overlap, 3)


def test_magnification_plan_matches_jax(rng):
    img = _synthetic(rng, 512, 384)
    for power, mags, base in ((None, (0,), 20), ("40", (0,), 20),
                              ("40", (0, 2), 20), ("30", (0, 1), 20),
                              ("20", (1, 0), 10)):
        ours, theirs = slide.ImageBackend(img), jslide.ImageBackend(img)
        if power:
            ours.properties = theirs.properties = {
                "openslide.objective-power": power}
        got = slide.magnification_plan(slide.DeepZoom(ours, 64), mags, base,
                                       20)
        want = jslide.magnification_plan(jslide.DeepZoom(theirs, 64), mags,
                                         base, 20)
        assert got == want
    below = slide.ImageBackend(img)
    below.properties = {"openslide.objective-power": "10"}
    with pytest.raises(ValueError, match="below the requested"):
        slide.magnification_plan(slide.DeepZoom(below, 64), (0,), 20, 20)


def test_edge_energy_matches_jax(rng):
    tiles = [np.full((64, 64, 3), 255, np.uint8),
             (rng.random((64, 64, 3)) * 255).astype(np.uint8),
             _synthetic(rng, 64, 64, tissue=0.3),
             (rng.random((40, 64, 3)) * 255).astype(np.uint8)]  # a ragged edge
    for tile in tiles:
        assert tiler.edge_energy(tile, 64) == jtiler.edge_energy(tile, 64)
    # FIND_EDGES' border makes a white tile's score ~1000 / tile_size
    white = np.full((224, 224, 3), 255, np.uint8)
    assert tiler.edge_energy(white, 224) < 15 < tiler.edge_energy(tiles[1], 64)


@pytest.mark.parametrize("mags", [(0,), (0, 1)], ids=["single", "pyramid"])
def test_tile_slide_matches_jax(tmp_path, rng, mags):
    """The same files (names and decoded pixels) and the same counts in
    both layouts. Tissue fills the top-left quadrant; 2-pixel lines every
    128 rows below it pass the filter at low magnification only, so the
    pyramid drops those low patches for want of children."""
    img = _synthetic(rng, 512, 512, tissue=0.5)
    for y in (316, 444):
        img[y:y + 2] = 0
    path = _pyramid_tiff(img, str(tmp_path / "WSI" / "ds" / "tumor" / "s.tif"))
    cfg = dict(tile_size=128, overlap=0, workers=2, base_mag=20, objective=20)
    got = tiler.tile_slide(path, str(tmp_path / "port"), mags,
                           tiler.TilerConfig(**cfg))
    want = jtiler.tile_slide(path, str(tmp_path / "jax"), mags,
                             jtiler.TilerConfig(**cfg))
    for field in ("written", "filtered", "errors"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.written > 0 and got.filtered > 0 and got.tiles_per_sec > 0
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    bag = tmp_path / "port" / "tumor" / "s"
    if len(mags) == 2:
        assert sorted(os.listdir(bag)) == ["0_0", "0_0.jpeg"]
        assert len(os.listdir(bag / "0_0")) == 4


def test_tiler_cli_matches_jax_cli(tmp_path, rng):
    for cls, seed in (("a", 1), ("b", 2)):
        _pyramid_tiff(_synthetic(np.random.default_rng(seed), 320, 256),
                      str(tmp_path / "WSI" / "ds" / cls / f"s{seed}.tif"),
                      levels=2)
    argv = ["-d", "ds", "-v", "tif", "-s", "64", "-j", "2", "-e", "1",
            "-t", "10"]
    assert tiler_cli.main(argv + ["--wsi_root", str(tmp_path / "WSI")]) == 0
    os.rename(tmp_path / "WSI" / "ds" / "single", tmp_path / "port")
    assert jax_tiler_cli.main(argv + ["--wsi_root", str(tmp_path / "WSI")]) == 0
    _assert_same_tree(str(tmp_path / "port"),
                      str(tmp_path / "WSI" / "ds" / "single"))


def test_crop_slide_grid_matches_jax(tmp_path, rng):
    img = _synthetic(rng, 700, 600, tissue=0.5)
    img[300:, 350:] = (rng.random((300, 350, 3)) * 40 + 200).astype(np.uint8)
    path = _pyramid_tiff(img, str(tmp_path / "s.tif"), levels=3)
    for name, fn in (("port", crop_cli.crop_slide_grid),
                     ("jax", jax_crop_cli.crop_slide_grid)):
        kept = fn(path, str(tmp_path / name / "patches"),
                  str(tmp_path / name / "thumbs"), step=48, patch_size=64,
                  thumb_divisor=7, log=lambda s: None)
        assert kept > 0
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_crop_single_cli_matches_jax_cli(tmp_path, monkeypatch, rng):
    from PIL import Image

    for name, fn in (("port", crop_cli.main), ("jax", jax_crop_cli.main)):
        d = tmp_path / name
        os.makedirs(d / "test-c16" / "input")
        Image.fromarray(_synthetic(np.random.default_rng(3), 300, 260)).save(
            d / "test-c16" / "input" / "one.tif")
        monkeypatch.chdir(d)
        assert fn(["--dataset", "c16", "--patch_size", "64",
                   "--overlap", "8"]) == 0
    _assert_same_tree(str(tmp_path / "port" / "test-c16"),
                      str(tmp_path / "jax" / "test-c16"))


def test_saturation_helpers_match_jax(rng):
    img = rng.integers(0, 256, (32, 40, 3), np.uint8)
    img[0, :5] = 0  # max 0: saturation 0
    np.testing.assert_array_equal(image.rgb_to_saturation(img),
                                  jimage.rgb_to_saturation(img))
    assert image.mean_saturation_ubyte(img) == jimage.mean_saturation_ubyte(img)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(image.rgb_to_saturation(f),
                                  jimage.rgb_to_saturation(f))


class _Parsed(Exception):
    pass


def _jax_parser(main, monkeypatch):
    """The argparse parser a JAX CLI builds inside its main()."""
    got = {}

    def grab(self, *args, **kwargs):
        got["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main([])
    return got["parser"]


def _flags(parser):
    return {a.dest: (a.default, tuple(a.option_strings), a.nargs, a.type)
            for a in parser._actions}


@pytest.mark.parametrize("ours,theirs", [
    (tiler_cli, jax_tiler_cli), (crop_cli, jax_crop_cli)],
    ids=["tiler", "crop_single"])
def test_cli_flags_match_jax(monkeypatch, ours, theirs):
    """Host-only CLIs: the JAX flags, short forms and defaults, and no
    --device on either side."""
    got = _flags(ours.build_parser())
    assert got == _flags(_jax_parser(theirs.main, monkeypatch))
    assert "device" not in got


@pytest.mark.skipif(not native.available(),
                    reason="native tile service not built (make -C native)")
def test_native_backend_and_filter_match_pil(tmp_path, rng):
    img = _synthetic(rng, 512, 384, tissue=0.6)
    path = str(tmp_path / "tiled.tif")
    native.write_tiled_pyramid(path, img, tile=256, levels=2, quality=95,
                               description="Aperio |AppMag = 20|")
    ours, theirs = slide.NativeTiffBackend(path), jslide.NativeTiffBackend(path)
    assert ours.level_dimensions == theirs.level_dimensions
    assert ours.objective_power(40) == 20.0
    np.testing.assert_array_equal(ours.read_region((100, 50), 0, (64, 64)),
                                  theirs.read_region((100, 50), 0, (64, 64)))
    from PIL import Image, ImageFilter, ImageStat

    tiles = np.stack([img[:64, :64], img[300:364, 400:464]])

    pil = [np.mean(ImageStat.Stat(Image.fromarray(t).filter(
        ImageFilter.FIND_EDGES)).sum) / 64 ** 2 for t in tiles]
    np.testing.assert_allclose(native.edge_energy_batch(tiles, 2), pil,
                               rtol=1e-4)
    from tpumil.utils import native as jnative

    native.encode_jpeg(tiles[1], str(tmp_path / "ours.jpg"), 70)
    jnative.encode_jpeg(tiles[1], str(tmp_path / "theirs.jpg"), 70)
    assert ((tmp_path / "ours.jpg").read_bytes()
            == (tmp_path / "theirs.jpg").read_bytes())
