"""The port's host helpers, RNG keys and camera against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jeng
import rust_raytrace_tpu_torch.engine as teng
from rust_raytrace_tpu.models import circles
from rust_raytrace_tpu.ops.intersect_pallas import (
    fold_pages_origin as j_fold_pages_origin)
from rust_raytrace_tpu.ops.intersect_perlane import (
    build_perlane_tables as j_build_perlane_tables)
from rust_raytrace_tpu.ops.pages import build_pages_kd
from rust_raytrace_tpu_torch.ops.intersect import fold_pages_origin
from rust_raytrace_tpu_torch.ops.intersect_perlane import build_perlane_tables
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key

F32 = np.float32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prng_key_and_fold_in_equal_jax(seed):
    """Bitwise: the engine seeds wave w with key_data(fold_in(key, w))."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng_key(seed),
                                  np.asarray(jax.random.key_data(key)))
    for wave in range(5):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, wave)))
        np.testing.assert_array_equal(fold_in(prng_key(seed), wave),
                                      want.astype(np.uint32))


@pytest.mark.parametrize("h,w,tile", [(27, 48, 1), (54, 96, 1), (64, 64, 32),
                                      (32, 48, 16), (24, 40, 8)])
def test_tile_helpers_equal_jax(h, w, tile):
    assert teng.pick_tile(w, h) == jeng.pick_tile(w, h)
    np.testing.assert_array_equal(teng.tile_permutation(h, w, 1, tile),
                                  jeng.tile_permutation(h, w, 1, tile))


@pytest.mark.parametrize("n_tris", [10, 2068, 7168, 7200, 120_000, 262_144])
def test_auto_page_size_equal_jax(n_tris):
    assert teng.auto_page_size(n_tris) == jeng.auto_page_size(n_tris)


@pytest.mark.parametrize("quant", [True, False])
def test_assemble_host_image_equal_jax(quant):
    rng = np.random.default_rng(3)
    _, vp = circles.build(resolution=(48, 27))
    perm = teng.tile_permutation(27, 48, 1, teng.pick_tile(48, 27))
    R = 1408
    img = (rng.integers(0, 256, (3, R)).astype(np.uint8) if quant
           else rng.uniform(0, 1, (3, R)).astype(F32))
    np.testing.assert_array_equal(
        teng._assemble_host_image(img, vp, perm, 1, quant),
        jeng._assemble_host_image(img, vp, perm, 1, quant))


@pytest.mark.parametrize("res", [(48, 27), (64, 64), (96, 54), (640, 360)])
def test_camera_rays_tiled_equal_jax(res):
    """Bitwise: the image-plane point with XLA's fused multiply-adds (C2),
    the normalization with its reduction order and its CPU rsqrt (C1)."""
    _, vp = circles.build(resolution=res)
    tile = teng.pick_tile(vp.width, vp.height)
    R = -(-vp.width * vp.height // 128) * 128
    jo, jd = jeng._camera_rays_tiled(
        jnp.asarray(vp.orig), jnp.asarray(vp.cam), jnp.asarray(vp.vu),
        jnp.asarray(vp.vv), jax.random.PRNGKey(0), width=vp.width,
        height=vp.height, spp=1, tile=tile, n_pad=R)
    to, td = teng.camera_rays_tiled(vp, tile, R, "cpu")
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_build_perlane_tables_equal_jax():
    scene, _ = circles.build(resolution=(8, 8))
    pages = build_pages_kd(scene.tris, page_size=8)     # 259 pages: 3 banks
    for mine, ref in zip(build_perlane_tables(pages),
                         j_build_perlane_tables(pages)):
        np.testing.assert_array_equal(mine, ref)


def test_fold_pages_origin_equal_jax():
    """Bitwise: each folded lane is c - (a*o0 + b*o1 + c*o2) with the
    multiply-adds fused as XLA fuses them (ROADMAP C2)."""
    scene, vp = circles.build(resolution=(8, 8))
    pages = build_pages_kd(scene.tris, page_size=56)
    cam = np.asarray(vp.cam, F32) + F32(0.25)
    mine = fold_pages_origin(torch.from_numpy(pages.PK), cam).numpy()
    ref = np.asarray(j_fold_pages_origin(jnp.asarray(pages.PK),
                                         jnp.asarray(cam)))
    np.testing.assert_array_equal(mine, ref)
    assert (mine[..., 12:16] != pages.PK[..., 12:16]).any()


def test_page_lists_sort_like_jax():
    """Stable argsort: +inf (culled) pages keep page order, as
    jnp.argsort(stable=True) orders them."""
    rng = np.random.default_rng(11)
    tmin = rng.uniform(0, 5, (16, 37)).astype(F32)
    tmin[rng.uniform(size=tmin.shape) < 0.6] = np.inf
    tmin[:, 5] = tmin[:, 9]                      # finite ties too
    mask = np.isfinite(tmin)
    counts, plist, ptmin = teng.page_lists(torch.from_numpy(mask),
                                           torch.from_numpy(tmin))
    np.testing.assert_array_equal(counts.numpy(), mask.sum(1))
    np.testing.assert_array_equal(
        plist.numpy(), np.asarray(jnp.argsort(tmin, axis=1, stable=True)))
    np.testing.assert_array_equal(ptmin.numpy(),
                                  np.asarray(jnp.sort(tmin, axis=1)))


def test_quantize_u8_equal_jax():
    x = np.asarray([[0.0, 1.0, 0.5, -0.2, 1.7, np.nan, np.inf, -np.inf,
                     0.999999, 1 / 255, 0.003921]], F32)
    np.testing.assert_array_equal(teng.quantize_u8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jeng._quantize_u8(jnp.asarray(x))))
