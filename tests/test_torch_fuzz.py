"""Seeded random scenes through the port's whole Engine on the CPU against
the JAX Engine in interpret mode (tests/test_fuzz.py's scenes: a triangle
soup, a lat/lon sphere and a thick disk, with solid, matte and reflective
materials and a random camera pose): u8, float image and wave_rays bitwise,
under fixed and live RNG, with the default (compacted) Engine; and the
port's legacy loop on the same scene."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.utils import png
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_fuzz import _rand_scene, _rand_viewport
from test_torch_engine import carry

RB = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def soup():
    """Seed 47 of test_fuzz.py's mixed scene: 122 triangles of all three
    material kinds, 32x24, maxdepth 4."""
    rng = np.random.default_rng(47)
    jscene = _rand_scene(rng, n_soup=3, spheres=[(6, 8)], disks=[5])
    assert set(np.unique(jscene.tris.materials.kind[1:])) == {0, 1, 2}
    vp = _rand_viewport(rng, (32, 24), maxdepth=4)
    return jscene, carry(jscene), vp


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_random_scene_equals_jax_engine(soup, fixed_rng):
    jscene, scene, vp = soup
    ref = JEngine(jscene, ray_chunk=RB, page_size=16,
                  interpret=True).render(vp, key=jax.random.PRNGKey(4),
                                         fixed_rng=fixed_rng, quantize=False)
    assert ref.wave_rays[1] > 0
    eng = Engine(scene, ray_chunk=RB, page_size=16, device="cpu")
    mine_f = eng.render(vp, key=prng_key(4), fixed_rng=fixed_rng,
                        quantize=False)
    mine_u8 = eng.render(vp, key=prng_key(4), fixed_rng=fixed_rng)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.image.view(np.uint32),
                                  ref.image.view(np.uint32))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))
    if fixed_rng:
        legacy = Engine(scene, ray_chunk=RB, page_size=16, device="cpu",
                        compact=False).render(vp, fixed_rng=True,
                                              quantize=False)
        np.testing.assert_array_equal(legacy.image.view(np.uint32),
                                      ref.image.view(np.uint32))
