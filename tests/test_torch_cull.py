"""B1: the port's cull against cull_mask_exact_pallas in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective
from rust_raytrace_tpu.ops.cull_pallas import cull_mask_exact_pallas
from rust_raytrace_tpu.ops.pages import build_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.ops.cull import cull_mask_exact
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32
RB = 128
R = 4 * RB


def _scene(lat_lon):
    s = make_sphere((0.0, 0.0, 6.0), 2.0, lat_lon,
                    matte(m3.make_color((200, 60, 60)), 0.3), -1.0)
    floor = make_triangles(
        np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32),
        reflective(m3.make_color((120, 120, 120)), 0.8, 0.1), 0.0)
    return assemble([s, floor])


def _rays(kind, seed=2):
    """Camera-like rays from one point, or scattered ones; some direction
    components exactly 0 (the +-1e30 reciprocal) and dead lanes."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o = np.zeros((3, R), F32)
        d = np.stack([rng.uniform(-0.4, 0.4, R), rng.uniform(-0.3, 0.3, R),
                      np.ones(R)]).astype(F32)
    else:
        o = rng.uniform(-3, 3, (3, R)).astype(F32)
        o[2] += 6.0
        d = rng.normal(size=(3, R)).astype(F32)
    d[0, ::7] = 0.0
    d[1, ::11] = 0.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    valid = rng.uniform(size=R) > 0.1
    return o, d.astype(F32), valid


@pytest.mark.parametrize("kind", ["camera", "scattered"])
@pytest.mark.parametrize("lat_lon,page", [((8, 12), 16), ((24, 30), 8)])
def test_cull_bitwise_equal_pallas(kind, lat_lon, page):
    """Pure IEEE sub/mul/div/min/max: mask and tmin are bitwise equal (the
    second scene has 2 banks of pages, the TPU kernel's bank pre-slab)."""
    pages = build_pages_kd(_scene(lat_lon).tris, page_size=page)
    o, d, valid = _rays(kind)
    native.reset_launch_counts()
    mask, tmin = cull_mask_exact(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(pages.aabb_lo),
                                 torch.from_numpy(pages.aabb_hi), RB)
    jm, jt = cull_mask_exact_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        jnp.asarray(pages.aabb_lo), jnp.asarray(pages.aabb_hi), RB,
        interpret=True)
    assert mask.any()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jt))
    assert native.CULL.launches == 0          # CPU tensors: plain version
