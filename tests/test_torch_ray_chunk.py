"""ray_chunk above 1024: the port's Engine on the CPU against the JAX
Engine in interpret mode, bitwise, at the tune grid's two largest chunks.

The card's kernels whose block is one chunk (B1, B2, B6, B12a) take a
chunk of up to 4096 rays since the cap in `utils/native.check_ray_chunk`
rose to the JAX Engine's 4096; the per-ray kernels use ray_chunk only in
`chunk_live` and the scatter hash, which these renders hold to the JAX
package's (live RNG keys the hash on the chunk and the lane within it).
tests/test_torch_cuda.py and chip_smoke.py hold the kernels to their plain
versions at 2048 and 4096 on the card."""

import numpy as np
import pytest
import torch

from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import prng_key


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (ray_chunk, resolution, maxdepth): one chunk of 2048 rays, one of 4096
#: (the JAX render in interpret mode takes most of a minute at 4096: two
#: waves keep it under)
CASES = [(2048, (64, 32), 3), (4096, (64, 64), 2)]


@pytest.mark.parametrize("rc,res,maxdepth", CASES)
def test_engine_ray_chunk_equals_jax(rc, res, maxdepth):
    import jax

    jscene, jvp = jcircles.build(resolution=res, maxdepth=maxdepth)
    scene, vp = circles.build(resolution=res, maxdepth=maxdepth)
    assert vp.width * vp.height % rc == 0
    want = JEngine(jscene, ray_chunk=rc, interpret=True).render(
        jvp, key=jax.random.PRNGKey(0), quantize=False)
    native.reset_launch_counts()
    got = Engine(scene, ray_chunk=rc, device="cpu").render(
        vp, key=prng_key(0), quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(got.image.view(np.uint32),
                                  np.asarray(want.image).view(np.uint32))
    np.testing.assert_array_equal(got.wave_rays, np.asarray(want.wave_rays))
    assert got.wave_rays[-1] > 0


@pytest.mark.parametrize("rc", [2048, 4096])
def test_check_ray_chunk_takes_up_to_4096(rc):
    native.check_ray_chunk(2 * rc, rc)


@pytest.mark.parametrize("R,rc", [(8192, 8192), (4096 * 3, 6144),
                                  (4096, 1000), (4096, 16), (3072, 2048)])
def test_check_ray_chunk_refuses(R, rc):
    with pytest.raises(ValueError, match=r"\[32, 4096\]"):
        native.check_ray_chunk(R, rc)
