"""`Engine.render_banded` on the CPU: the banded image equals render()'s
bit for bit under fixed_rng for two band splits at spp 1 and spp 4, in the
compacted and the legacy loop and in the streamed regime through the
bank-major sweep; under live RNG it equals JAX `Engine.render_banded` in
interpret mode (u8, float image by bit pattern, wave_rays); its progress
reports and its band_rows check."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import Engine, camera_rays_tiled, pick_tile
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key

from test_torch_engine import carry

RB = 128
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: with several test
    workers on one host, torch's intra-op threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x):
    return np.asarray(x, F32).view(np.uint32)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.wave_rays, b.wave_rays)
    assert a.rays_traced == b.rays_traced
    if a.image.dtype == np.uint8:
        np.testing.assert_array_equal(a.image, b.image)
    else:
        np.testing.assert_array_equal(bits(a.image), bits(b.image))


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("band_rows", [16, 32])
def test_render_banded_equals_render(spp, band_rows):
    """circles 64x48 (tile 16) in three bands of 16 rows or in bands of 32
    and 16: the u8 and float images and the summed wave counts of
    render()."""
    scene, vp = circles.build(resolution=(64, 48), maxdepth=4, samples=spp)
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    assert pick_tile(vp.width, vp.height) == 16
    for quantize in (True, False):
        full = eng.render(vp, fixed_rng=True, quantize=quantize)
        band = eng.render_banded(vp, fixed_rng=True, band_rows=band_rows,
                                 quantize=quantize)
        _assert_same(band, full)
    assert band.primary_t is None and full.image.max() > 0


def test_render_banded_equals_render_legacy_loop():
    """The legacy loop (Engine(compact=False)) banded: render()'s bits."""
    scene, vp = circles.build(resolution=(64, 48), maxdepth=4)
    eng = Engine(scene, ray_chunk=RB, compact=False, device="cpu")
    _assert_same(eng.render_banded(vp, fixed_rng=True, band_rows=16,
                                   quantize=False),
                 eng.render(vp, fixed_rng=True, quantize=False))


def test_render_banded_streamed_bank_major():
    """A sphere forced into the streamed regime with the bank-major sweep,
    banded: render()'s bits."""
    scene = carry(assemble([make_sphere(
        (0.0, 0.0, 6.0), 2.5, (24, 24),
        matte(m3.make_color((252, 119, 0)), 0.2), 0.0)]))
    vp = create_viewport((32, 24), (1.0, 0.75), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                 bank_major=True, device="cpu")
    assert eng.stables[0].shape[0] >= 2
    full = eng.render(vp, fixed_rng=True, quantize=False)
    assert full.wave_rays[2] > 0
    _assert_same(eng.render_banded(vp, fixed_rng=True, band_rows=8,
                                   quantize=False), full)


def test_band_rays_are_the_full_streams():
    """camera_rays_tiled at q_base = a band's first stream position gives
    the full stream's rays there (spp 4: the jitter keys on position)."""
    _, vp = circles.build(resolution=(64, 48), samples=4)
    tile = pick_tile(vp.width, vp.height)
    R = 64 * 48 * 4
    key = prng_key(6)
    o, d, _ = camera_rays_tiled(vp, tile, R, "cpu", key)
    q0, n = 16 * 64 * 4, 2048
    ob, db, _ = camera_rays_tiled(vp, tile, n, "cpu", key, q_base=q0)
    np.testing.assert_array_equal(bits(ob), bits(o[:, q0:q0 + n]))
    np.testing.assert_array_equal(bits(db), bits(d[:, q0:q0 + n]))


@pytest.mark.parametrize("fixed_rng", [False, True])
def test_render_banded_equals_jax(fixed_rng):
    """circles 32x24 (tile 8) in three bands of 8 rows, against JAX
    `Engine.render_banded(interpret=True)`: the per-band scatter key
    fold_in(key, band) under live RNG, the u8 and float images and the
    summed wave counts."""
    jscene, vp = jcircles.build(resolution=(32, 24), maxdepth=4)
    jeng = JEngine(jscene, ray_chunk=RB, interpret=True)
    ref = jeng.render_banded(vp, key=jax.random.PRNGKey(2),
                             fixed_rng=fixed_rng, band_rows=8,
                             quantize=False)
    eng = Engine(carry(jscene), ray_chunk=RB, device="cpu")
    native.reset_launch_counts()
    mine_f = eng.render_banded(vp, key=prng_key(2), fixed_rng=fixed_rng,
                               band_rows=8, quantize=False)
    mine_u8 = eng.render_banded(vp, key=prng_key(2), fixed_rng=fixed_rng,
                                band_rows=8)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    assert mine_f.rays_traced == ref.rays_traced
    np.testing.assert_array_equal(bits(mine_f.image), bits(ref.image))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))
    if not fixed_rng:
        # the bands' scatter keys differ from the whole render's
        whole = eng.render(vp, key=prng_key(2), quantize=False)
        assert not np.array_equal(bits(whole.image), bits(mine_f.image))


class _Progress:
    """Records what render_banded reports."""

    def __init__(self):
        self.updates, self.stats = [], {}

    def update(self, pixels, runstats):
        self.updates.append((pixels, dict(runstats)))

    def _stat(self, name, kind):
        stats = self.stats

        class _S:
            def add(self, v):
                stats[name] = stats.get(name, 0) + v
        return _S()


def test_render_banded_reports_progress():
    """One update per band (its pixels and rays), then each wave's total,
    as the JAX Engine reports them."""
    scene, vp = circles.build(resolution=(64, 48), maxdepth=3)
    prog = _Progress()
    res = Engine(scene, ray_chunk=RB, device="cpu").render_banded(
        vp, fixed_rng=True, band_rows=16, progress=prog)
    assert [p for p, _ in prog.updates] == [16 * 64] * 3
    assert sum(s["Rays"] for _, s in prog.updates) == res.rays_traced
    assert prog.stats == {f"Wave{i}Rays": int(n)
                          for i, n in enumerate(res.wave_rays)}


@pytest.mark.parametrize("band_rows", [12, 0, -16])
def test_render_banded_rejects_band_rows(band_rows):
    """band_rows must be a positive multiple of the pixel tile (16 here);
    the default sizes bands by max_band_rays."""
    scene, vp = circles.build(resolution=(64, 48), maxdepth=2)
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    with pytest.raises(ValueError, match="multiple of the 16-px tile"):
        eng.render_banded(vp, fixed_rng=True, band_rows=band_rows)
    auto = eng.render_banded(vp, fixed_rng=True, max_band_rays=64 * 20)
    _assert_same(auto, eng.render(vp, fixed_rng=True))
