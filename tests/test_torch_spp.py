"""The port's Engine at spp > 1 on the CPU against the JAX Engine in
interpret mode, bitwise, and compacted == legacy at spp 4."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.utils import png
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_torch_engine import carry

RB = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("spp", [2, 3, 4])
def test_spp_equals_jax_engine(spp):
    """spp 2 and 4 box-filter and quantize on the device; spp 3 renders
    float and quantizes on the host (the JAX `_device_quantizable`).  The
    position-keyed jitter, the lcm padding and both images bitwise, with
    live RNG (key 1); the JAX Engine's u8 image is png.quantize_u8 of its
    float one at every spp (its contract), so one JAX render serves."""
    jscene, vp = jcircles.build(resolution=(24, 16), maxdepth=4, samples=spp)
    ref_f = JEngine(jscene, ray_chunk=RB, interpret=True).render(
        vp, key=jax.random.PRNGKey(1), quantize=False)
    eng = Engine(carry(jscene), ray_chunk=RB, device="cpu")
    mine_f = eng.render(vp, key=prng_key(1), quantize=False)
    mine_u8 = eng.render(vp, key=prng_key(1))
    np.testing.assert_array_equal(_u32(mine_f.image), _u32(ref_f.image))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref_f.image))
    assert mine_u8.image.dtype == np.uint8
    np.testing.assert_array_equal(mine_f.wave_rays, ref_f.wave_rays)
    assert mine_f.wave_rays[0] == 24 * 16 * spp


def test_spp4_compacted_equals_legacy():
    """tests/test_bitexact.py::test_spp4_compact_equals_legacy on the port:
    float image and u8 bitwise under fixed_rng."""
    scene, vp = circles.build(resolution=(48, 27), maxdepth=4, samples=4)
    e1 = Engine(scene, ray_chunk=RB, device="cpu")
    e0 = Engine(scene, ray_chunk=RB, device="cpu", compact=False)
    for quantize in (False, True):
        i1 = e1.render(vp, fixed_rng=True, quantize=quantize).image
        i0 = e0.render(vp, fixed_rng=True, quantize=quantize).image
        np.testing.assert_array_equal(i1, i0)
