"""The port's CUDA kernels on the card against their plain versions.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports no jax, so it runs on a machine without it:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from rust_raytrace_tpu.models import circles
from rust_raytrace_tpu.utils import png
from rust_raytrace_tpu_torch.engine import (Engine, camera_rays_tiled,
                                            page_lists, pick_tile)
from rust_raytrace_tpu_torch.ops import cull, intersect, intersect_perlane
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "circles_96x54.png")
RB = 128


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wave0(dev):
    """The engine and the wave-0 state of circles at 96x54."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    eng = Engine(scene, ray_chunk=RB, device=dev)
    R = -(-vp.width * vp.height // RB) * RB
    o, d = camera_rays_tiled(vp, pick_tile(vp.width, vp.height), R, dev)
    o, pk0 = eng._pinhole_fold(vp, o)
    alive = (torch.arange(R, device=dev) < vp.width * vp.height).float()
    st = torch.cat([o, d, alive[None], alive[None],
                    torch.zeros((8, R), device=dev)])
    return eng, st, pk0


def _assert_states(got, want):
    assert torch.equal(got[[7, 11]], want[[7, 11]])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernels_match_plain(wave0):
    eng, st, pk0 = wave0
    P = eng.page_size
    args = (st[0:3], st[3:6], st[7] != 0, eng.aabb_lo, eng.aabb_hi, RB)
    mask, tmin = cull.cull_mask_exact(*args)
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)

    counts, plist, ptmin = page_lists(mask, tmin)
    # the unfolded pages with the true origins (zero_origin=False) too
    args = (st, eng.PK, counts, plist, ptmin, fold_in(prng_key(3), 0), P, RB,
            False, 1 / 512)
    _assert_states(intersect.trace_shade_chunks(*args),
                   intersect.trace_shade_chunks_plain(*args))
    for fixed in (True, False):
        args = (st, pk0, counts, plist, ptmin, fold_in(prng_key(3), 0), P,
                RB, fixed, 1 / 512)
        st1 = intersect.trace_shade_chunks(*args, zero_origin=True)
        _assert_states(st1, intersect.trace_shade_chunks_plain(
            *args, zero_origin=True))
        live = (st1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        args = (st1, eng.plt_i, eng.plt_s, eng.ab, fold_in(prng_key(3), 1),
                P, RB, fixed, 1 / 512, live)
        _assert_states(intersect_perlane.trace_shade_perlane(*args),
                       intersect_perlane.trace_shade_perlane_plain(*args))


def test_golden_on_card_launches_every_kernel(dev):
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    eng = Engine(scene, device=dev)
    native.reset_launch_counts()
    img = eng.render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(img, png.read_png(GOLDEN))
    assert [k.launches for k in native.KERNELS] == [1, 1, vp.maxdepth - 1]
