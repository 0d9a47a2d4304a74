"""The traffic generators are deterministic by seed, and every seed gets
the same work in another order."""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import arrivals, bags, images

BAGS = {"bags": 64, "median": 4096, "sigma": 1.0, "min": 256,
        "max": 65536, "feats": 512, "classes": 2}
SERVE = {"rate_per_s": 20.0, "min_patches": 16, "max_patches": 256}


def test_bag_sizes_are_one_set_for_every_seed():
    a = bags.draw(BAGS, np.random.default_rng([1]))
    b = bags.draw(BAGS, np.random.default_rng([1]))
    c = bags.draw(BAGS, np.random.default_rng([2 ** 31 + 5]))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert np.array_equal(np.sort(a[0]), np.sort(c[0]))
    sizes = bags.bag_sizes(BAGS)
    assert sizes.min() >= 256 and sizes.max() <= 65536
    assert abs(np.median(sizes) - 4096) <= 0.1 * 4096
    assert np.all(a[1].sum(axis=1) == 1)


def test_bag_features_follow_the_generator():
    g = torch.Generator().manual_seed(7)
    x = bags.features(100, 8, g, "cpu")
    y = bags.features(100, 8, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(x, y) and bool((x >= 0).all())


def test_arrivals_are_one_set_for_every_seed():
    d1, s1 = arrivals.schedule(SERVE, 30, np.random.default_rng([3]))
    d2, s2 = arrivals.schedule(SERVE, 30, np.random.default_rng([3]))
    d3, s3 = arrivals.schedule(SERVE, 30, np.random.default_rng([4]))
    assert np.array_equal(d1, d2) and np.array_equal(s1, s2)
    assert len(s1) == 600 and np.array_equal(np.sort(s1), np.sort(s3))
    assert d1[0] > 0 and np.all(np.diff(d1) >= 0) and 28 < d1[-1] < 31
    assert s1.min() >= 16 and s1.max() <= 256
    # the gaps of every seed are the same quantiles of the exponential
    g1 = np.sort(np.diff(d1, prepend=0.0))
    g3 = np.sort(np.diff(d3, prepend=0.0))
    assert np.allclose(g1, g3) and not np.allclose(d1, d3)


def test_tissue_images_follow_the_generator():
    a = images.tissue(3, 32, torch.Generator().manual_seed(9), "cpu")
    b = images.tissue(3, 32, torch.Generator().manual_seed(9), "cpu")
    c = images.tissue(3, 32, torch.Generator().manual_seed(10), "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 32, 32, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 < a.float().std() and a.float().mean() > 60


def test_jpegs_round_trip(tmp_path):
    from portbench.reference.resnet import decode_jpegs

    imgs = images.tissue(2, 32, torch.Generator().manual_seed(1),
                         "cpu").numpy()
    paths = [str(tmp_path / "a" / f"{i}.jpeg") for i in range(2)]
    images.write_jpegs(imgs, paths, 70, workers=2)
    back = decode_jpegs(paths, workers=2)
    assert back.shape == imgs.shape
    assert np.abs(back.astype(int) - imgs.astype(int)).mean() < 20
