"""B11's redesign on the CPU: the dead-ray mask of `nearest_hit` and its
plain version; the kernel's order of tests (its staged slots without the
zero-normal padding rows, then per pair the division, the exact
lexicographic test and the plane distances one at a time), emulated pair
by pair against the plain version, on random soups, exact ties, grazing
rays at a shared edge and padding rays; that a zero-normal row never wins
against any ray; and the WavefrontRenderer's "kernel" backend, which
passes each wave's mask, bitwise against the JAX package's
`pallas_interpret` backend."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.ops.pages import build_pages as jbuild_pages
from rust_raytrace_tpu.render import WavefrontRenderer as JRenderer
from rust_raytrace_tpu.scene import assemble
import rust_raytrace_tpu_torch.render as trender
from rust_raytrace_tpu_torch.ops.intersect import (
    nearest_hit, nearest_hit_plain, packed_hit_predicate)
from rust_raytrace_tpu_torch.ops.pages import (LANE_ID, LANE_N, LANE_NC,
                                               LANE_S0, LANE_S0C)
from rust_raytrace_tpu_torch.ops.shade import fma
from rust_raytrace_tpu_torch.render import WavefrontRenderer
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_fuzz import _rand_scene, _rand_viewport
from test_torch_engine import carry

F32 = np.float32
INF = np.float32(np.inf)
TINY = np.float32(2.0 ** -149)          # the least subnormal
FMIN = np.float32(2.0 ** -126)          # the least normal
FMAX = np.finfo(F32).max


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(seed=3, ties=False):
    """tests/test_torch_portable.py's soup and sphere (R = 1000 rays, not a
    multiple of the kernel's span), page size 32."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, (60, 3, 3)) * 0.6
           + rng.uniform(-2, 2, (60, 1, 3)) + [0, 0, 6]).astype(F32)
    if ties:
        pts = np.concatenate([pts, pts[:20]])
    scene = assemble([
        make_triangles(pts, matte(m3.make_color((200, 100, 50)), 0.3), 0.05),
        make_sphere((0.5, 0.0, 7.0), 1.5, (6, 8),
                    matte(m3.make_color((20, 200, 50)), 0.3), 0.05)])
    R = 1000
    O = (rng.uniform(-1, 1, (R, 3)) * [1, 1, 0.5]).astype(F32)
    D = (rng.uniform(-0.6, 0.6, (R, 3)) + [0, 0, 1]).astype(F32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return O, D, jbuild_pages(scene.tris, page_size=32)


@pytest.mark.parametrize("ties", [False, True])
def test_plain_mask_writes_dead_rays_inf_zero(ties):
    """Dead rays get (+inf, 0); live rays the unmasked result, bit for bit;
    the wrapper on CPU tensors is the plain version and launches nothing."""
    O, D, pages = _soup(ties=ties)
    args = (torch.from_numpy(O), torch.from_numpy(D),
            torch.from_numpy(pages.PK))
    alive = torch.from_numpy(np.random.default_rng(8).uniform(size=len(O))
                             < 0.4)
    full_t, full_id = nearest_hit_plain(*args)
    native.reset_launch_counts()
    for t, i in (nearest_hit_plain(*args, alive=alive),
                 nearest_hit(*args, 32, alive=alive)):
        assert torch.equal(t[alive].view(torch.int32),
                           full_t[alive].view(torch.int32))
        assert torch.equal(i[alive], full_id[alive])
        assert torch.isinf(t[~alive]).all() and (t[~alive] > 0).all()
        assert not i[~alive].any() and i.dtype == torch.int32
    assert native.NEAREST_HIT.launches == 0
    assert 0 < int((full_id[alive] != 0).sum()) < int(alive.sum())


def _edge_rays():
    """Grazing rays at a shared edge: two triangles of one quad, rays aimed
    at points on and next to their diagonal, so that dv lands on 1 and
    the two t values tie."""
    quad = np.asarray([[[0, 0, 5], [1, 0, 5], [1, 1, 6]],
                       [[0, 0, 5], [1, 1, 6], [0, 1, 6]]], F32)
    pages = jbuild_pages(assemble([make_triangles(
        quad, matte(m3.make_color((9, 9, 9)), 0.1), 0.0)]).tris,
        page_size=8)
    s = np.linspace(0.0, 1.0, 41, dtype=F32)
    eps = np.asarray([0, 1e-7, -1e-7, 2.0 ** -30], F32)
    pts = np.stack(np.meshgrid(s, eps, indexing="ij"), -1).reshape(-1, 2)
    target = np.stack([pts[:, 0] + pts[:, 1], pts[:, 0],
                       5 + pts[:, 0]], -1).astype(F32)
    O = np.zeros_like(target)
    D = (target / np.linalg.norm(target, axis=1, keepdims=True)).astype(F32)
    return O, D, pages


def _kernel_fold(O, D, PK):
    """The CUDA kernel's order of tests, emulated: the slots whose normal
    is not zero, each ray folding them in order; per pair the division,
    then only a t >= 0 that passes the lexicographic test goes on to the
    plane distances, stopping at the first one past 1.  Returns (best_t,
    best_id int32, share of pairs stopped before any plane distance)."""
    pk = torch.from_numpy(PK.reshape(-1, PK.shape[-1]))
    pk = pk[(pk[:, LANE_N:LANE_N + 3] != 0).any(dim=1)]
    o = torch.from_numpy(np.ascontiguousarray(O.T))
    d = torch.from_numpy(np.ascontiguousarray(D.T))
    R = o.shape[1]
    bt = torch.full((R,), torch.inf)
    bi = torch.zeros(R)
    stopped = 0
    for row in pk:
        def dot3(f, r, row=row):
            return fma(row[f + 2], r[2], fma(row[f], r[0], row[f + 1] * r[1]))

        t = (row[LANE_NC] - dot3(LANE_N, o)) / dot3(LANE_N, d)
        ids = row[LANE_ID]
        go = (t >= 0) & ((t < bt) | ((t == bt) & ~torch.isinf(t))
                         & (ids < bi))
        stopped += int((~go).sum())
        for k in range(3):
            f = LANE_S0 + 3 * k
            dv = fma(t, dot3(f, d), dot3(f, o)) - row[LANE_S0C + k]
            go = go & (dv <= 1.0)
        bt = torch.where(go, t, bt)
        bi = torch.where(go, ids, bi)
    return bt, bi.to(torch.int32), stopped / (R * pk.shape[0])


@pytest.mark.parametrize("case", ["soup", "ties", "grazing edge",
                                  "padding rays"])
def test_kernel_order_of_tests_equals_plain(case):
    """The emulated kernel gives the plain version's t and id bit for bit:
    a random soup and sphere, the same with 20 triangles repeated on other
    pages (exact t ties across pages), rays grazing a quad's shared edge
    (both triangles accept some of them at one t) and d = 0 padding rays
    among the soup's; and the lexicographic test stops a fair share of the
    pairs before their plane distances."""
    if case == "grazing edge":
        O, D, pages = _edge_rays()
    else:
        O, D, pages = _soup(ties=case == "ties")
        if case == "padding rays":
            D[::7] = 0.0
    bt, bi, share = _kernel_fold(O, D, pages.PK)
    pt, pi = nearest_hit_plain(torch.from_numpy(O), torch.from_numpy(D),
                               torch.from_numpy(pages.PK))
    assert torch.equal(bt.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(bi, pi)
    assert 0 < int((pi != 0).sum()) < O.shape[0]
    assert share > (0.01 if case == "grazing edge" else 0.2)
    if case == "grazing edge":
        pk = torch.from_numpy(pages.PK.reshape(-1, pages.PK.shape[-1]))
        t, ok, _, _, _ = packed_hit_predicate(
            lambda f: pk[:, f:f + 1],
            tuple(torch.from_numpy(O[:, k].copy())[None] for k in range(3)),
            tuple(torch.from_numpy(D[:, k].copy())[None] for k in range(3)))
        tt = torch.where(ok, t, torch.inf)
        assert ((ok & (tt == tt.amin(dim=0))).sum(dim=0) == 2).any()


#: float32 values at the edges of the format
SPECIALS = np.asarray(
    [0.0, -0.0, TINY, -TINY, FMIN, -FMIN, 1.0, -1.0, 3.0, -0.5, FMAX,
     -FMAX, INF, -INF, np.nan], F32)


def test_zero_normal_rows_never_win():
    """A slot whose normal is +-0 (what the kernel leaves out of its
    stage) fails the update against every ray and every running best t:
    md_n is +-0 or NaN, so t is +-inf or NaN.  Its other lanes and the
    rays' origins and directions take special values."""
    rng = np.random.default_rng(6)
    n_rows = 512
    rows = rng.choice(SPECIALS, (n_rows, 24)).astype(F32)
    rows[:, LANE_N:LANE_N + 3] = rng.choice(np.asarray([0.0, -0.0], F32),
                                            (n_rows, 3))
    rows[:8] = 0.0                          # the pages' padding rows
    o = rng.choice(SPECIALS, (3, 256)).astype(F32)
    d = rng.choice(SPECIALS, (3, 256)).astype(F32)
    d[:, :64] = rng.normal(size=(3, 64)).astype(F32)
    pk = torch.from_numpy(rows)

    def col(f):
        return pk[:, f:f + 1]

    t, ok, ids, _, _ = packed_hit_predicate(
        col, tuple(torch.from_numpy(o[k])[None] for k in range(3)),
        tuple(torch.from_numpy(d[k])[None] for k in range(3)))
    assert (torch.isinf(t) | torch.isnan(t)).all()
    for best in (np.inf, 1.0, FMIN, 0.0, FMAX):
        bt = torch.full_like(t, float(best))
        wins = ok & ((t < bt) | ((t == bt) & ~torch.isinf(t)))
        assert not wins.any()


def _spy_masks(monkeypatch):
    """Record the alive mask each "kernel" wave hands to nearest_hit."""
    seen = []
    real = trender.nearest_hit

    def spy(o, d, PK, page_size, ray_chunk=1024, alive=None):
        seen.append(None if alive is None else alive.clone())
        return real(o, d, PK, page_size, ray_chunk, alive=alive)

    monkeypatch.setattr(trender, "nearest_hit", spy)
    return seen


def _fuzz_scene():
    rng = np.random.default_rng(47)
    jscene = _rand_scene(rng, n_soup=3, spheres=[(6, 8)], disks=[5])
    return jscene, _rand_viewport(rng, (32, 24), maxdepth=4)


@pytest.mark.parametrize("scene", ["circles", "fuzz"])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_wavefront_kernel_with_mask_equals_jax(scene, fixed_rng,
                                               monkeypatch):
    """WavefrontRenderer(backend="kernel") skips each wave's dead rays and
    still equals JAX's pallas_interpret backend bitwise: float image,
    primary t and id, wave_rays."""
    if scene == "circles":
        jscene, vp = jcircles.build(resolution=(32, 18), maxdepth=4)
    else:
        jscene, vp = _fuzz_scene()
    kw = dict(ray_chunk=256, page_size=64)
    ref = JRenderer(jscene, backend="pallas_interpret", **kw).render(
        vp, key=jax.random.PRNGKey(4), fixed_rng=fixed_rng)
    seen = _spy_masks(monkeypatch)
    mine = WavefrontRenderer(carry(jscene), backend="kernel", device="cpu",
                             **kw).render(vp, key=prng_key(4),
                                          fixed_rng=fixed_rng)
    for got, want in ((mine.image, ref.image),
                      (mine.primary_t, ref.primary_t)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    np.testing.assert_array_equal(mine.primary_id, ref.primary_id)
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    assert len(seen) == vp.maxdepth and seen[0].all()
    assert [int(a.sum()) for a in seen] == mine.wave_rays.tolist()
    assert not seen[-1].all()
