"""The port's shade (B0b), the standalone shade (B8), the scatter hash, the
shadow feeler's jitter and rsqrt against the JAX functions."""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.shade import _mix32 as j_mix32
from rust_raytrace_tpu.ops.shade import _shade_state_rows as j_shade
from rust_raytrace_tpu.ops.shade import scatter_rv as j_scatter_rv
from rust_raytrace_tpu.ops.shade import shade_pallas
from rust_raytrace_tpu.ops.shade import shadow_uvs as j_shadow_uvs
from rust_raytrace_tpu_torch.ops.shade import (fma, rsqrt, scatter_rv,
                                               scatter_uniforms, shade,
                                               shade_state_rows, shadow_uvs)
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32


SEED = np.asarray([0x9E3779B9, 0x7F4A7C15], np.uint32)
CHUNKS = (0, 1, 37, 3599)


@pytest.mark.parametrize("rb", [128, 1024])
def test_scatter_uniforms_bitwise(rb):
    """The hash is integer arithmetic: bitwise equal.  JAX's `_mix32` with
    salt 0 is scatter_rv's hash before the normalization."""
    for chunk in CHUNKS:
        rays = torch.arange(chunk * rb, (chunk + 1) * rb)
        mine = np.stack([u.numpy()
                         for u in scatter_uniforms(SEED, rays, rb)])
        word = (np.arange(3, dtype=np.uint32)[:, None] * np.uint32(rb)
                + np.arange(rb, dtype=np.uint32)[None, :])
        ref = j_mix32(jnp.asarray(word), jnp.uint32(SEED[0]),
                      jnp.uint32(SEED[1]), jnp.int32(chunk), 0)
        np.testing.assert_array_equal(mine, np.asarray(ref))


@pytest.mark.parametrize("rb", [128, 1024])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_scatter_rv_equal_jax(rb, fixed_rng):
    """Bitwise against the jitted JAX scatter_rv: the normalization is
    XLA-CPU's rsqrt (ROADMAP C1) after its fused sum of squares."""
    f = jax.jit(functools.partial(j_scatter_rv, rb=rb, fixed_rng=fixed_rng))
    for chunk in CHUNKS:
        rays = torch.arange(chunk * rb, (chunk + 1) * rb)
        v, inv = scatter_rv(SEED, rays, rb, fixed_rng)
        mine = np.stack([(x if inv is None else x * inv).numpy() for x in v])
        ref = f(jnp.uint32(SEED[0]), jnp.uint32(SEED[1]), jnp.int32(chunk))
        ref = np.broadcast_to(np.concatenate([np.asarray(r) for r in ref]),
                              (3, rb))
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("lo,hi", [(1e-3, 1e3), (0.98, 1.02)])
def test_rsqrt_equal_xla_cpu(lo, hi):
    """1,000,000 seeded inputs, bitwise against jax.jit(jax.lax.rsqrt)."""
    x = np.random.default_rng(21).uniform(lo, hi, 1_000_000).astype(F32)
    mine = rsqrt(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))


def test_rsqrt_equal_xla_cpu_on_any_bits_and_special_values():
    """Random bit patterns (every class: subnormals, negatives, NaNs) and the
    special values, bitwise (NaN payloads included)."""
    bits = np.random.default_rng(22).integers(0, 2**32, 1_000_000,
                                              dtype=np.uint64)
    special = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, -1.0,
                          1e-45, -1e-45, 1e-39, 1.17549435e-38, 3.4028235e38,
                          1.0, 2.0, 4.0, 0.25], F32)
    x = np.concatenate([bits.astype(np.uint32).view(F32), special])
    mine = rsqrt(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))


def test_rsqrt_table_cache_equals_a_fresh_capture():
    """The words kept beside the capture binary are what it prints now."""
    import subprocess
    from rust_raytrace_tpu_torch.utils import xla_rsqrt
    cached = xla_rsqrt.host_table()
    fresh = subprocess.run([str(xla_rsqrt._binary())], capture_output=True,
                           check=True).stdout
    np.testing.assert_array_equal(cached, np.frombuffer(fresh, "<u4"))


def test_fma_is_correctly_rounded():
    """The float64 emulation rounds once: against exact rational
    arithmetic on products whose float64 sum lands on float32 ties."""
    rng = np.random.default_rng(23)
    a = rng.uniform(-2, 2, 4000).astype(F32)
    b = rng.uniform(-2, 2, 4000).astype(F32)
    c = (rng.uniform(-2, 2, 4000)
         * rng.choice([1e-9, 1e-4, 1.0, 1e4], 4000)).astype(F32)
    # c = -a*b rounded to float32 plus a half-ulp: sums at float32 ties
    c[:1000] = (-(a[:1000].astype(np.float64) * b[:1000])).astype(F32)
    mine = fma(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(c)).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        assert mine[i] == _nearest_f32(exact), (a[i], b[i], c[i])


def _nearest_f32(exact):
    """The float32 nearest the rational `exact`, ties to even."""
    near = F32(float(exact))
    cands = [np.nextafter(near, F32(-np.inf)), near,
             np.nextafter(near, F32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - exact),
                                     int(np.asarray(y).view(np.int32)) & 1))


@pytest.mark.parametrize("above", [True, False])
def test_fma_rounds_once_where_the_float64_sum_is_inexact(above):
    """a*b far below c, with the exact sum a hair above (or below) a float32
    tie: the float64 sum rounds onto the tie, and only the TwoSum error can
    tell which way float32 must round.  a*b = 2**(e-24) * A*B / 2**47 with
    A*B within 2**18 of 2**47, so the hair lies below c's float64 ulp."""
    rng = np.random.default_rng(24 + above)
    A = rng.integers(2**23, 2**24, 200_000, dtype=np.int64)
    B = -(-(2**47) // A) if above else 2**47 // A
    k = A * B - 2**47
    keep = (k != 0) & (np.abs(k) < 2**18) & (B < 2**24)
    A, B = A[keep][:600], B[keep][:600]
    n = A.size
    e = rng.integers(-20, 20, n)
    sign_p = rng.choice([-1.0, 1.0], n)
    a = (sign_p * A * np.exp2(e - 47.0)).astype(F32)
    b = (B * np.exp2(-24.0)).astype(F32)
    c = (rng.choice([-1.0, 1.0], n) * rng.integers(2**23, 2**24, n)
         * np.exp2(e - 23.0)).astype(F32)
    # the worked case: 1+2**-23 plus just under half its ulp
    a = np.append(a, F32(1 + 2**-23))
    b = np.append(b, F32(2**-24 * (1 - 2**-23)))
    c = np.append(c, F32(1 + 2**-23))
    mine = fma(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        assert mine[i] == _nearest_f32(exact), (a[i], b[i], c[i])
    assert mine[-1] == F32(1 + 2**-23)


def _state_and_rows(seed, n=2048):
    """Random ray state and winner rows covering every shade branch: miss,
    solid, matte, reflective, edge and back faces, dead lanes."""
    rng = np.random.default_rng(seed)
    st = np.zeros((16, n), F32)
    st[0:3] = rng.uniform(-5, 5, (3, n))
    d = rng.normal(size=(3, n))
    st[3:6] = d / np.linalg.norm(d, axis=0)
    st[6] = rng.uniform(0.001, 1, n)
    st[7] = rng.uniform(size=n) > 0.1
    st[8:11] = rng.uniform(0, 0.5, (3, n))
    st[11] = rng.uniform(size=n) > 0.8
    rows = np.zeros((16, n), F32)
    rows[0] = rng.uniform(0.01, 10, n)
    rows[1] = np.where(rng.uniform(size=n) < 0.2, 0, rng.integers(1, 999, n))
    nrm = rng.normal(size=(3, n))
    rows[2:5] = nrm / np.linalg.norm(nrm, axis=0)
    kind = rng.integers(0, 3, n)
    rows[5] = (kind + 4 * (rng.uniform(size=n) < 0.1)
               + 8 * (rng.uniform(size=n) < 0.5))
    rows[6:9] = rng.uniform(0, 1, (3, n))
    rows[9] = rng.uniform(0, 1, n)
    rows[10] = rng.uniform(0, 0.5, n)
    return st, rows


@pytest.mark.parametrize("fixed_rng,cutoff", [(True, 0.0), (False, 1 / 512),
                                              (False, 0.0)])
def test_shade_state_rows_matches_jax(fixed_rng, cutoff):
    """Against the jitted JAX shade: alive, retired, direction, weight and
    color rows exact; origins within 1e-5 relative.  The port reproduces
    the contractions XLA makes inside the trace kernels (held bitwise in
    test_torch_intersect.py and test_torch_perlane.py); a standalone jit
    fuses the new origin's products differently (ROADMAP C2)."""
    st, rows = _state_and_rows(17)
    n = st.shape[1]
    seed = np.asarray([12345, 678], np.uint32)
    rays = torch.arange(n)
    rv = scatter_rv(seed, rays, n, fixed_rng)
    mine = shade_state_rows(torch.from_numpy(st), torch.from_numpy(rows),
                            rv, cutoff).numpy()

    @jax.jit
    def ref_fn(st, rows, s0, s1):
        jrv = j_scatter_rv(s0, s1, jnp.int32(0), n, fixed_rng)
        return j_shade(st, rows, *jrv, None, cutoff)

    ref = np.asarray(ref_fn(jnp.asarray(st), jnp.asarray(rows),
                            jnp.uint32(seed[0]), jnp.uint32(seed[1])))
    np.testing.assert_array_equal(mine[3:], ref[3:])
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rb", [128, 1024])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_shadow_uvs_bitwise(rb, fixed_rng):
    """The feeler's jitter (salted lowbias32) against JAX's, per chunk."""
    for chunk in CHUNKS:
        rays = torch.arange(chunk * rb, (chunk + 1) * rb)
        u3, u1 = shadow_uvs(SEED, rays, rb, fixed_rng)
        ref3, ref1 = j_shadow_uvs(jnp.uint32(SEED[0]), jnp.uint32(SEED[1]),
                                  jnp.int32(chunk), rb, fixed_rng)
        np.testing.assert_array_equal(np.stack([u.numpy() for u in u3]),
                                      np.asarray(ref3))
        np.testing.assert_array_equal(u1.numpy(), np.asarray(ref1)[0])
    if not fixed_rng:
        assert 0.45 < float(u1.mean()) < 0.55


@pytest.mark.parametrize("fixed_rng,cutoff", [(True, 0.0), (False, 1 / 512)])
@pytest.mark.parametrize("with_shadow", [False, True])
def test_shade_matches_pallas(fixed_rng, cutoff, with_shadow):
    """B8 through its wrapper against shade_pallas in interpret mode, the
    whole state bitwise: 8 chunks of 256, one of them dead, a third of the
    lanes shadowed."""
    st, rows = _state_and_rows(31)
    rb = 256
    n = st.shape[1]
    seed = np.asarray([4242, 99], np.uint32)
    live = np.ones(n // rb, np.int32)
    live[3] = 0
    shd = (np.random.default_rng(32).uniform(size=n) < 0.33).astype(F32) \
        if with_shadow else None
    native.reset_launch_counts()
    mine = shade(torch.from_numpy(st), torch.from_numpy(rows), seed, rb,
                 fixed_rng, cutoff, torch.from_numpy(live),
                 None if shd is None else torch.from_numpy(shd)).numpy()
    assert native.SHADE.launches == 0                # CPU: plain version
    ref = np.asarray(shade_pallas(
        jnp.asarray(st), jnp.asarray(rows), jnp.asarray(seed), rb=rb,
        fixed_rng=fixed_rng, weight_cutoff=cutoff,
        chunk_live=jnp.asarray(live),
        shadowed=None if shd is None else jnp.asarray(shd[None]),
        interpret=True))
    np.testing.assert_array_equal(mine[:, 3 * rb:4 * rb], st[:, 3 * rb:4 * rb])
    np.testing.assert_array_equal(mine[[7, 8, 9, 10, 11]],
                                  ref[[7, 8, 9, 10, 11]])
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))
