"""The port's own copies of the JAX package's reference helpers, bitwise
against the JAX functions on seeded inputs: the compaction oracles
(`compact_oracle`, `expand_oracle`, `compact_oracle_buckets`,
`expand_oracle_buckets`), `cull_mask`, the exact per-ray slab test
`ray_aabb_hits` (and the cull's conservativeness against it),
`device_pages`, and `compact_meta`'s self-gating trigger (`gate_frac`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.ops.compact as jc
import rust_raytrace_tpu.ops.cull as jcull
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.ops.cull_pallas import cull_mask_exact_pallas
from rust_raytrace_tpu.ops.intersect_xla import device_pages as jdevice_pages
from rust_raytrace_tpu.ops.pages import build_pages_kd as jbuild_pages_kd
import rust_raytrace_tpu_torch.ops.compact as tc
from rust_raytrace_tpu_torch.ops import cull
from rust_raytrace_tpu_torch.ops.intersect_xla import device_pages
from rust_raytrace_tpu_torch.ops.pages import build_pages_kd

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _state(R, p_alive, p_dead, seed):
    """Random payload bits, alive and retired lanes exclusive; one chunk of
    512 all alive, one all retired and one empty where R allows (the
    states of tests/test_torch_compact.py)."""
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(16, R)).astype(F32)
    u = rng.uniform(size=R)
    alive = u < p_alive
    dead = ~alive & (u < p_alive + p_dead)
    st[7] = alive
    st[11] = dead
    if R >= 2048:
        st[7, 0:512], st[11, 0:512] = 1.0, 0.0
        st[7, 512:1024], st[11, 512:1024] = 0.0, 1.0
        st[7, 1024:1536], st[11, 1024:1536] = 0.0, 0.0
    return st


#: (R, cb, p_alive, p_dead, dead_base): tests/test_torch_compact.py's cases
#: and an overflowing boundary (64-lane chunks, each padded to 128 lanes:
#: the oracle's identity pass-through)
ORACLE_CASES = [
    (1024, 128, 0.3, 0.3, 0),
    (1024, 128, 0.0, 0.0, 0),
    (1024, 256, 1.0, 0.0, 0),
    (1536, 512, 0.0, 1.0, 384),
    (4096, 512, 0.2, 0.5, 256),
    (4096, 512, 0.6, 0.1, 1024),
    (4096, 128, 0.05, 0.9, 0),
    (1024, 64, 0.5, 0.3, 128),
]


@pytest.mark.parametrize("R,cb,pa,pd,base", ORACLE_CASES)
def test_compact_oracles_equal_jax(R, cb, pa, pd, base):
    st = _state(R, pa, pd, 3 * R + cb)
    # 64-lane chunks pad their dead segments to twice their lanes
    dead0 = np.zeros((8, 4 * R), F32)
    dead0[:, :base] = 5.0
    mine = tc.compact_oracle(st, dead0, cb, base)
    ref = jc.compact_oracle(st, dead0, cb, base)
    for a, b in zip(mine[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert tuple(mine[3:]) == tuple(ref[3:])
    if cb < 128:
        # the engine never expands an identity boundary from the oracle
        assert mine[4] and (mine[2][:, tc.M_IDENT] == 1).all()
        return
    y = mine[0][8:16]
    back = tc.expand_oracle(y, mine[1], st[7], st[11], mine[2], cb)
    ref_back = jc.expand_oracle(y, mine[1], st[7], st[11], mine[2], cb)
    np.testing.assert_array_equal(_bits(back), _bits(ref_back))


def _bucket_state(rng, R: int, cb: int, n_oct: int):
    """tests/test_torch_compact_buckets.py's state: codes in row 12, chunk
    0 idle, the rest alive (bucket < n_oct) / retired / gap; -0 and NaN
    payload words."""
    st = rng.normal(size=(16, R)).astype(F32)
    u = rng.random(R)
    alive = u < 0.4
    dead = (u >= 0.4) & (u < 0.7)
    alive[:cb] = dead[:cb] = False
    code = np.zeros(R, F32)
    code[alive] = 2.0 + rng.integers(0, n_oct, size=R)[alive]
    code[dead] = 1.0
    st[tc.ROW_CODE] = code
    st[8, cb:cb + 40] = -0.0
    st[9, cb + 3] = np.uint32(0x7FC12345).view(F32)
    return st, code


@pytest.mark.parametrize("cb,R,dead_base,n_oct", [
    (256, 256 * 6, 0, 2), (256, 256 * 7, 256, 2), (512, 512 * 3, 256, 2),
    (256, 256 * 6, 0, 8), (512, 512 * 3, 0, 8)])    # the last two overflow
def test_bucket_oracles_equal_jax(cb, R, dead_base, n_oct):
    rng = np.random.default_rng(cb + R + dead_base + n_oct)
    st, code = _bucket_state(rng, R, cb, n_oct)
    dead0 = rng.normal(size=(8, 2 * R)).astype(F32)
    mine = tc.compact_oracle_buckets(st, dead0, cb, dead_base)
    ref = jc.compact_oracle_buckets(st, dead0, cb, dead_base)
    for a, b in zip(mine[:3], ref[:3]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (int(mine[3]), bool(mine[4]), int(mine[5])) == \
        (int(ref[3]), bool(ref[4]), int(ref[5]))
    assert bool(mine[4]) == (n_oct == 8)
    if mine[4]:
        return           # segments past R are not written, nor expanded
    y = mine[0][8:16]
    for c in (code, code[None]):
        back = tc.expand_oracle_buckets(y, mine[1], c, mine[2], cb)
        ref_back = jc.expand_oracle_buckets(y, mine[1], c, mine[2], cb)
        np.testing.assert_array_equal(_bits(back), _bits(ref_back))


def _rays(seed: int, R: int, blo, bhi, faces: str):
    """[R, 3] origins and directions: a fifth of the direction components
    +0 and some -0, and a sixth of the origin components on a face of a
    random box: its lower face ("lo"), either face ("both") or none."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (R, 3)).astype(F32)
    d = rng.normal(size=(R, 3)).astype(F32)
    d[rng.uniform(size=(R, 3)) < 0.2] = 0.0
    d[::7, 1] = -0.0
    if faces != "none":
        box = rng.integers(0, blo.shape[0], R)
        on = rng.uniform(size=(R, 3)) < 1 / 6
        upper = (rng.uniform(size=(R, 3)) < 0.5) & (faces == "both")
        o = np.where(on & upper, bhi[box], np.where(on, blo[box], o))
    return o.astype(F32), d


def _boxes(seed: int, NP: int):
    rng = np.random.default_rng(seed)
    blo = rng.uniform(-2.0, 1.0, (NP, 3)).astype(F32)
    return blo, (blo + rng.uniform(0.1, 2.0, (NP, 3))).astype(F32)


def _chunk_rays(seed: int, R: int, RB: int):
    """Coherent chunks: each chunk's origins near one point and its
    directions near one direction, with zero and -0 components."""
    rng = np.random.default_rng(seed)
    nc = R // RB
    o = (np.repeat(rng.uniform(-3.0, 3.0, (nc, 3)), RB, axis=0)
         + rng.uniform(-0.05, 0.05, (R, 3))).astype(F32)
    d = (np.repeat(rng.normal(size=(nc, 3)), RB, axis=0)
         + rng.normal(scale=0.05, size=(R, 3))).astype(F32)
    d[rng.uniform(size=(R, 3)) < 0.2] = 0.0
    d[::7, 1] = -0.0
    return o, d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("faces", ["none", "lo", "both"])
def test_ray_aabb_hits_equals_jax(faces):
    blo, bhi = _boxes(1, 37)
    o, d = _rays(2, 2048, blo, bhi, faces)
    ref = np.asarray(jcull.ray_aabb_hits(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(blo), jnp.asarray(bhi)))
    mine = cull.ray_aabb_hits(_t(o), _t(d), _t(blo), _t(bhi))
    assert mine.dtype == torch.bool and mine.shape == (2048, 37)
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("RB", [128, 256])
def test_cull_mask_equals_jax(RB):
    """The chunk-bound cull's mask half on bounds of rays with zero
    direction components, per chunk and per octant (the legacy loop's
    two forms)."""
    blo, bhi = _boxes(3, 37)
    o, d = _chunk_rays(4, 2048, RB)
    valid = np.random.default_rng(5).uniform(size=2048) < 0.9
    jb = jcull.chunk_bounds(jnp.asarray(o.T), jnp.asarray(d.T),
                            jnp.asarray(valid), RB)
    tb = cull.chunk_bounds(_t(o.T), _t(d.T), _t(valid), RB)
    ref = np.asarray(jcull.cull_mask(*jb, jnp.asarray(blo), jnp.asarray(bhi)))
    mine = cull.cull_mask(*tb, _t(blo), _t(bhi))
    np.testing.assert_array_equal(mine.numpy(), ref)
    # the mask is the tmin variant's
    np.testing.assert_array_equal(
        mine.numpy(), cull.cull_mask_tmin(*tb, _t(blo), _t(bhi))[0].numpy())
    assert 0 < ref.sum() < ref.size


def _misses(o, d, blo, bhi, RB):
    """Pages `ray_aabb_hits` finds for a ray that its chunk's B1 mask (the
    plain version, every ray valid) lacks: [n, 3] (chunk, lane, page)."""
    R = o.shape[0]
    hits = cull.ray_aabb_hits(_t(o), _t(d), _t(blo), _t(bhi)).numpy()
    mask, _ = cull.cull_mask_exact_plain(_t(o.T), _t(d.T),
                                         torch.ones(R, dtype=torch.bool),
                                         _t(blo), _t(bhi), RB)
    miss = hits.reshape(R // RB, RB, -1) & ~mask.numpy()[:, None, :]
    return np.argwhere(miss), hits


@pytest.mark.parametrize("faces", ["none", "lo"])
@pytest.mark.parametrize("RB", [128, 1024])
def test_b1_mask_holds_every_exact_hit(faces, RB):
    """Conservativeness, chunk by chunk: every page the exact slab test
    finds for a ray is in its chunk's B1 mask, with zero direction
    components, -0, and origins off the boxes or on their lower faces."""
    blo, bhi = _boxes(6, 37)
    o, d = _rays(7 + RB, 2048, blo, bhi, faces)
    miss, hits = _misses(o, d, blo, bhi, RB)
    assert hits.sum() > 0
    assert len(miss) == 0, miss[:5]


def test_b1_drops_a_parallel_ray_on_an_upper_face_as_jax_does():
    """The one place where B1 is not conservative, in the JAX kernel as in
    the port: a ray with d_k == 0 (+0 or -0) whose origin lies exactly on
    a box's upper face on axis k and that enters the box at t > 0 on
    another axis.  B1's finite reciprocal (+1e30) makes that axis's exit
    (hi - o) * 1e30 = 0, so the chunk misses the page; the exact test
    admits every t there.  The port keeps the JAX kernel's bits, so every
    miss on the seeded rays is of this kind and JAX's B1 in interpret mode
    gives the same mask."""
    blo, bhi = _boxes(6, 37)
    RB = 128
    o, d = _rays(8, 1024, blo, bhi, "both")
    # the last chunk: two such rays at box 0, on lanes in turn
    o[-RB:] = [bhi[0, 0], 0.5 * (blo[0, 1] + bhi[0, 1]), blo[0, 2] - 1.0]
    d[-RB:] = [0.0, 0.0, 1.0]
    d[-RB::2, 0] = -0.0
    miss, _ = _misses(o, d, blo, bhi, RB)
    assert {(7, 0, 0), (7, 1, 0)} <= {tuple(m) for m in miss}
    for c, lane, p in miss:
        r = c * RB + lane
        assert ((d[r] == 0) & (o[r] == bhi[p])).any(), (o[r], d[r], p)
    mask, tmin = cull.cull_mask_exact_plain(
        _t(o.T), _t(d.T), torch.ones(1024, dtype=torch.bool), _t(blo),
        _t(bhi), RB)
    jmask, jtmin = cull_mask_exact_pallas(
        jnp.asarray(o.T), jnp.asarray(d.T), jnp.ones(1024, bool),
        jnp.asarray(blo), jnp.asarray(bhi), RB, interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(_bits(tmin.numpy()), _bits(jtmin))


def test_b1_zero_entry_is_positive_zero_as_jax():
    """A ray whose origin lies on a box's upper face and that leaves along
    the axis enters at (hi - o) * inv = -0: B1's tmin is +0 there, as the
    JAX kernel's max(tlo, 0) writes it."""
    blo = np.zeros((1, 3), F32)
    bhi = np.ones((1, 3), F32)
    o = np.tile(np.asarray([[1.0, 0.5, 0.5]], F32), (128, 1))
    d = np.tile(np.asarray([[-1.0, 0.2, 0.1]], F32), (128, 1))
    mask, tmin = cull.cull_mask_exact_plain(
        _t(o.T), _t(d.T), torch.ones(128, dtype=torch.bool), _t(blo),
        _t(bhi), 128)
    jmask, jtmin = cull_mask_exact_pallas(
        jnp.asarray(o.T), jnp.asarray(d.T), jnp.ones(128, bool),
        jnp.asarray(blo), jnp.asarray(bhi), 128, interpret=True)
    assert bool(mask[0, 0]) and bool(jmask[0, 0])
    np.testing.assert_array_equal(_bits(tmin.numpy()), _bits(jtmin))
    assert _bits(tmin.numpy())[0, 0] == 0


def test_device_pages_on_the_cpu_equals_jax():
    jscene, _ = jcircles.build(resolution=(16, 16))
    jpages = jbuild_pages_kd(jscene.tris, page_size=56)
    pages = build_pages_kd(jscene.tris, page_size=56)
    mine = device_pages(pages, device="cpu")
    ref = np.asarray(jdevice_pages(jpages))
    assert mine.device.type == "cpu" and mine.dtype == torch.float32
    np.testing.assert_array_equal(_bits(mine.numpy()), _bits(ref))
    if torch.cuda.is_available():
        assert device_pages(pages).device.type == "cuda"
    else:
        # the card by default: no silent fallback to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            device_pages(pages)


def _meta_pair(alive, cb, R, prefix, gate_frac):
    dead = np.zeros(R, F32)
    mine = tc.compact_meta(
        torch.from_numpy(alive), torch.from_numpy(dead), cb,
        torch.tensor(0, dtype=torch.int32), R,
        prefix=None if prefix is None else torch.tensor(prefix,
                                                        dtype=torch.int32),
        gate_frac=gate_frac)
    ref = jc.compact_meta(
        jnp.asarray(alive), jnp.asarray(dead), cb, jnp.int32(0), R,
        prefix=None if prefix is None else jnp.int32(prefix),
        gate_frac=gate_frac)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
    assert (int(mine[1]), bool(mine[2]), int(mine[3])) == \
        (int(ref[1]), bool(ref[2]), int(ref[3]))
    return bool(mine[2]), int(mine[0][0, tc.M_IDENT])


def test_compact_meta_self_gating_equals_jax():
    """JAX tests/test_aux.py's cases: 600 survivors (640 padded) of 1024."""
    R, cb = 1024, 256
    alive = (np.arange(R) < 600).astype(F32)
    assert _meta_pair(alive, cb, R, None, None) == (False, 0)
    assert _meta_pair(alive, cb, R, None, 0.5) == (True, 1)
    assert _meta_pair(alive, cb, R, 1024, 0.7) == (False, 0)
    assert _meta_pair(alive, cb, R, 768, 0.7)[0]


@pytest.mark.parametrize("seed", range(6))
def test_compact_meta_gate_edges_equal_jax(seed):
    """Prefixes at total_a / gate_frac and one lane either side, on seeded
    survivor counts and fractions: the float32 decision flips there."""
    rng = np.random.default_rng(seed)
    R, cb = 4096, 512
    n = int(rng.integers(1, 24)) * 128
    alive = (np.arange(R) < n).astype(F32)
    frac = float(rng.choice([0.1, 0.3, 0.55, 0.65, 0.7, 0.9]))
    edge = int(round(n / frac))
    flips = set()
    for p in (edge - 1, edge, edge + 1):
        flips.add(_meta_pair(alive, cb, R, p, frac)[0])
    assert flips == {True, False}


def test_compact_meta_gate_rounds_in_float32():
    """total_a = 896, prefix 1280, gate_frac 0.7: float32(0.7) * 1280 is
    895.99998 before rounding and 896.0 in float32, so the boundary
    compacts (as in JAX); a float64 product of the same float32 fraction
    would skip it."""
    R, cb = 2048, 512
    alive = (np.arange(R) < 896).astype(F32)
    assert _meta_pair(alive, cb, R, 1280, 0.7) == (False, 0)
    assert 896 > float(np.float32(0.7)) * 1280
