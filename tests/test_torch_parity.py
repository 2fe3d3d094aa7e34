"""The port's parity statistics (`rust_raytrace_tpu_torch/utils/parity.py`)
against the JAX package's, exactly, on seeded images and on the committed
circles golden."""

import os

import numpy as np
import pytest

from rust_raytrace_tpu.utils import parity as jparity
from rust_raytrace_tpu_torch.utils import parity
from rust_raytrace_tpu_torch.utils.png import read_png

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "circles_96x54.png")


def _image(g, h, w, sky_share: float, sky):
    """A seeded u8 image whose pixels are `sky` with probability
    sky_share (and within the tolerance of it half of those times), else
    uniform."""
    img = g.integers(0, 256, (h, w, 3)).astype(np.uint8)
    pick = g.random((h, w)) < sky_share
    near = np.clip(np.asarray(sky) + g.integers(-3, 4, (h, w, 3)), 0, 255)
    jitter = g.random((h, w)) < 0.5
    img[pick & ~jitter] = np.asarray(sky, np.uint8)
    img[pick & jitter] = near[pick & jitter].astype(np.uint8)
    return img


def _equal(a, b):
    """Equal values, NaN where the other is NaN."""
    return a == b or (np.isnan(a) and np.isnan(b))


def test_constants_equal_jax():
    np.testing.assert_array_equal(parity.GOLDEN_SKY, jparity.GOLDEN_SKY)
    np.testing.assert_array_equal(parity.OUR_SKY, jparity.OUR_SKY)
    assert parity.SKY_TOL == jparity.SKY_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("share", [0.0, 0.4, 1.0])
def test_parity_stats_equal_jax(seed, share):
    """share 0: no golden sky (sky diff NaN); 1: every pixel sky in both
    (IoU NaN)."""
    g = np.random.default_rng(100 * seed + int(share * 10))
    golden = _image(g, 27, 48, share, jparity.GOLDEN_SKY)
    ours = _image(g, 27, 48, share, jparity.OUR_SKY)
    if share == 1.0:
        ours[:] = jparity.OUR_SKY.astype(np.uint8)
    got = parity.parity_stats(ours, golden)
    want = jparity.parity_stats(ours, golden)
    assert got.keys() == want.keys()
    for k in want:
        assert _equal(got[k], want[k]), (k, got[k], want[k])
    if share == 0.0:
        assert np.isnan(got["sky_mean_abs_diff"])
    if share == 1.0:
        assert np.isnan(got["silhouette_iou"])


@pytest.mark.parametrize("factor", [1, 3, 8])
def test_downsample_and_sky_mask_equal_jax(factor):
    g = np.random.default_rng(factor)
    img = _image(g, 54, 97, 0.5, jparity.OUR_SKY)
    got = parity.downsample_u8(img, factor)
    want = jparity.downsample_u8(img, factor)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for sky in (parity.OUR_SKY, parity.GOLDEN_SKY):
        for x in (img, got):
            np.testing.assert_array_equal(parity.sky_mask(x, sky),
                                          jparity.sky_mask(x, sky))


def test_parity_stats_error_norms():
    """rmse must be sqrt(mean(sq)) and mae mean(|diff|) — pinned on a
    synthetic pair where the two differ by construction."""
    a = np.zeros((2, 2, 3), dtype=np.float32)
    b = np.zeros((2, 2, 3), dtype=np.float32)
    b[0, 0, :] = 255.0          # 3 of 12 channels differ by 1.0 (normalized)
    stats = parity.parity_stats(a, b)
    assert stats["mae"] == pytest.approx(3.0 / 12.0)
    assert stats["rmse"] == pytest.approx(np.sqrt(3.0 / 12.0))
    assert stats["rmse"] > stats["mae"]


def test_golden_against_itself():
    """The committed circles golden: exact parity with itself, equal to the
    JAX statistics on it against a shifted copy."""
    golden = read_png(GOLDEN)
    stats = parity.parity_stats(golden, golden)
    assert stats["rmse"] == 0.0 and stats["mae"] == 0.0
    assert stats["sky_mean_abs_diff"] == 0.0
    assert stats["silhouette_iou"] == 1.0
    assert 0.0 < stats["sky_fraction_golden"] < 1.0
    shifted = np.roll(golden, 5, axis=1)
    got = parity.parity_stats(shifted, golden)
    assert got == jparity.parity_stats(shifted, golden)
    assert got["silhouette_iou"] < 1.0
