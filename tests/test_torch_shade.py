"""The port's shade (B0b) and scatter hash against the JAX functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.shade import _mix32 as j_mix32
from rust_raytrace_tpu.ops.shade import _shade_state_rows as j_shade
from rust_raytrace_tpu.ops.shade import scatter_rv as j_scatter_rv
from rust_raytrace_tpu_torch.ops.shade import (scatter_rv, scatter_uniforms,
                                               shade_state_rows)

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
    """Bitwise under fixed_rng; with live RNG within 2 ulp, because the
    normalization's rsqrt on XLA's CPU is an estimate refined by Newton
    steps, up to an ulp off the port's 1/sqrt (ROADMAP C1)."""
    for chunk in CHUNKS:
        rays = torch.arange(chunk * rb, (chunk + 1) * rb)
        mine = np.stack([v.numpy()
                         for v in scatter_rv(SEED, rays, rb, fixed_rng)])
        ref = j_scatter_rv(jnp.uint32(SEED[0]), jnp.uint32(SEED[1]),
                           jnp.int32(chunk), rb, fixed_rng)
        ref = np.broadcast_to(np.concatenate([np.asarray(r) for r in ref]),
                              (3, rb))
        if fixed_rng:
            np.testing.assert_array_equal(mine, ref)
        else:
            assert (np.abs(mine - ref) <= 2 * np.spacing(np.abs(ref))).all()


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
    """Alive and retired rows exact; float rows within 1e-5 relative: XLA
    contracts multiply-adds (ROADMAP C2) and uses an approximate rsqrt
    (C1), so new origins and directions differ by ulps."""
    st, rows = _state_and_rows(17)
    n = st.shape[1]
    seed = np.asarray([12345, 678], np.uint32)
    rays = torch.arange(n)
    rv = scatter_rv(seed, rays, n, fixed_rng)
    mine = shade_state_rows(torch.from_numpy(st), torch.from_numpy(rows),
                            *rv, cutoff).numpy()
    jrv = j_scatter_rv(jnp.uint32(seed[0]), jnp.uint32(seed[1]),
                       jnp.int32(0), n, fixed_rng)
    ref = np.asarray(j_shade(jnp.asarray(st), jnp.asarray(rows), *jrv, None,
                             cutoff))
    np.testing.assert_array_equal(mine[[7, 11]], ref[[7, 11]])
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6)
