"""The port's device metric (`rust_raytrace_tpu_torch/utils/devbench.py`)
on the CPU: its loop counts the rays that render() counts under the same
keys, and the metric itself refuses a CPU Engine."""

import pytest
import torch

from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.utils import devbench
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    scene, vp = circles.build(resolution=(32, 18), maxdepth=4)
    return Engine(scene, ray_chunk=128, device="cpu"), vp


@pytest.mark.parametrize("run", [0, 1])
def test_device_loop_counts_the_renders_rays(small, run):
    """At spp 1 the camera rays do not depend on the key, so ND = 2 device
    renders under fold_in(key, i) trace the rays of render(key=fold_in(key,
    i)), i = 0, 1."""
    eng, vp = small
    key = prng_key(100 + run)
    total = devbench.device_loop(eng, vp, 2, key)
    assert total.device == eng.device and total.dtype == torch.int64
    want = sum(eng.render(vp, key=fold_in(key, i)).rays_traced
               for i in range(2))
    assert int(total) == want
    assert want > 2 * vp.width * vp.height


def test_primary_rays_are_the_renders(small):
    """The prepared rays: the render's padding, pinhole fold and live
    mask."""
    eng, vp = small
    o, d, alive0, pk0, quant = devbench.primary_rays(eng, vp)
    R0 = vp.width * vp.height
    assert o.shape == d.shape == (3, 640) and alive0.shape == (640,)
    assert int(alive0.sum()) == R0 and bool(alive0[:R0].all())
    assert quant and pk0 is not None
    assert torch.equal(o, o[:, :1].expand(o.shape))


def test_device_metric_refuses_a_cpu_engine(small):
    eng, vp = small
    with pytest.raises(RuntimeError, match="CUDA"):
        devbench.device_metric(eng, vp, ND=1, nruns=1)
