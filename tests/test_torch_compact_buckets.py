"""B14 on the CPU: the port's bucketed compaction (`compact_meta_buckets`,
and the plain versions behind `compact_buckets` and `expand_buckets` on CPU
tensors) against the JAX package's `compact_meta_buckets` and its
`compact_pallas_buckets` / `expand_pallas_buckets` in interpret mode,
bitwise: on a dead array whose lanes are not zero, with busy and idle
chunks, and with -0 and NaN payload words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.ops.compact as jcompact
from rust_raytrace_tpu_torch.ops import compact
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_state(rng, R: int, cb: int, n_oct: int = 2):
    """A [16, R] state with codes in row 12: chunk 0 idle (all gaps), the
    rest mixed alive (bucket < n_oct) / retired / gap; -0 and NaN words in
    the payload rows."""
    st = rng.normal(size=(16, R)).astype(F32)
    u = rng.random(R)
    alive = u < 0.4
    dead = (u >= 0.4) & (u < 0.7)
    alive[:cb] = dead[:cb] = False
    code = np.zeros(R, F32)
    code[alive] = 2.0 + rng.integers(0, n_oct, size=R)[alive]
    code[dead] = 1.0
    st[compact.ROW_CODE] = code
    st[8, cb:cb + 40] = -0.0
    st[9, cb + 3] = np.uint32(0x7FC12345).view(F32)
    st[10, cb + 5] = np.uint32(0xFFC00001).view(F32)
    st[11, cb + 7] = np.uint32(0x00000001).view(F32)      # a denormal
    return st, alive, dead, code


def bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


CASES = [(256, 256 * 6, 0), (256, 256 * 7, 256), (512, 512 * 3, 0),
         (512, 512 * 3, 256)]


@pytest.mark.parametrize("cb,R,dead_base", CASES)
def test_bucketed_round_trip_equals_jax_interpret(cb, R, dead_base):
    rng = np.random.default_rng(cb + R + dead_base)
    st, alive, dead, code = make_state(rng, R, cb)
    dead_arr = rng.normal(size=(8, 2 * R)).astype(F32)   # not zeros

    jm, jta, jov, jde = jcompact.compact_meta_buckets(
        jnp.asarray(code), cb, jnp.int32(dead_base), R)
    tm, tta, tov, tde = compact.compact_meta_buckets(
        torch.from_numpy(code), cb, torch.tensor(dead_base, dtype=torch.int32),
        R)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tta), bool(tov), int(tde)) == (int(jta), bool(jov), int(jde))
    assert not bool(tov)
    assert tm[0, compact.M9_BUSY] == 0 and tm[1:, compact.M9_BUSY].all()

    js, jd = jcompact.compact_pallas_buckets(
        jnp.asarray(st), jnp.asarray(dead_arr), jm, cb=cb, interpret=True)
    native.reset_launch_counts()
    ts, td = compact.compact_buckets(torch.from_numpy(st.copy()),
                                     torch.from_numpy(dead_arr.copy()), tm, cb)
    np.testing.assert_array_equal(bits(ts), bits(js))
    np.testing.assert_array_equal(bits(td), bits(jd))

    y = np.array(np.asarray(js)[compact.ROW_ACC:])
    jo = jcompact.expand_pallas_buckets(jnp.asarray(y), jd,
                                        jnp.asarray(code)[None], jm, cb=cb,
                                        interpret=True)
    to = compact.expand_buckets(torch.from_numpy(y), td,
                                torch.from_numpy(code)[None], tm, cb)
    assert native.COMPACT_BUCKETS.launches == 0
    assert native.EXPAND_BUCKETS.launches == 0
    np.testing.assert_array_equal(bits(to), bits(jo))
    # the round trip gives back rows 8..15 of every live and retired lane
    both = alive | dead
    np.testing.assert_array_equal(bits(to)[:, both],
                                  bits(st[compact.ROW_ACC:])[:, both])
    assert not bits(to)[:, ~both].any()


@pytest.mark.parametrize("cb,R", [(256, 256 * 6), (512, 512 * 3)])
def test_bucketed_overflow(cb, R):
    """All 8 buckets on a small array overflow (total_a > R): the JAX engine
    never compacts then, so only the meta and flags are compared with
    JAX's, and the port's plain version follows the segment rule of the
    JAX package's numpy oracle: a segment that would end past R is not
    written, so nothing is written out of bounds."""
    rng = np.random.default_rng(5)
    st, alive, dead, code = make_state(rng, R, cb, n_oct=8)
    jm, jta, jov, jde = jcompact.compact_meta_buckets(
        jnp.asarray(code), cb, jnp.int32(0), R)
    tm, tta, tov, tde = compact.compact_meta_buckets(
        torch.from_numpy(code), cb, torch.tensor(0, dtype=torch.int32), R)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tta), bool(tov), int(tde)) == (int(jta), bool(jov), int(jde))
    assert bool(tov) and int(tta) > R

    dead_arr = np.zeros((8, 2 * R), F32)
    exp_state, exp_dead, *_ = jcompact.compact_oracle_buckets(
        st, dead_arr, cb, 0)
    ts, td = compact.compact_buckets(torch.from_numpy(st.copy()),
                                     torch.from_numpy(dead_arr.copy()), tm, cb)
    np.testing.assert_array_equal(bits(ts), bits(exp_state))
    np.testing.assert_array_equal(bits(td), bits(exp_dead))
    # some segments were dropped, and the lanes of those that fit came back
    fits = np.zeros(R, bool)
    chunk = np.arange(R) // cb
    meta = tm.numpy()
    for b in range(compact.NB):
        ok = meta[:, 3 * b + 2] + compact.ALIGN * meta[:, 3 * b + 1] <= R
        fits |= (code == 2 + b) & ok[chunk]
    assert fits.sum() < alive.sum()
    y = ts[compact.ROW_ACC:].contiguous()
    out = compact.expand_buckets(y, td, torch.from_numpy(code)[None], tm, cb)
    keep = fits | dead
    np.testing.assert_array_equal(bits(out)[:, keep],
                                  bits(st[compact.ROW_ACC:])[:, keep])
    assert not bits(out)[:, ~keep].any()


@pytest.mark.parametrize("cb,R", [(256, 256 * 6), (512, 512 * 3)])
def test_bucketed_overflow_equals_port_oracle(cb, R):
    """The overflowing layout of `test_bucketed_overflow` against the port's
    own numpy oracle (its copy of the JAX one)."""
    rng = np.random.default_rng(5)
    st, alive, dead, code = make_state(rng, R, cb, n_oct=8)
    tm, tta, tov, tde = compact.compact_meta_buckets(
        torch.from_numpy(code), cb, torch.tensor(0, dtype=torch.int32), R)
    dead_arr = np.zeros((8, 2 * R), F32)
    exp_state, exp_dead, exp_meta, exp_ta, exp_ov, exp_de = \
        compact.compact_oracle_buckets(st, dead_arr, cb, 0)
    np.testing.assert_array_equal(tm.numpy(), exp_meta)
    assert (int(tta), bool(tov), int(tde)) == (exp_ta, exp_ov, exp_de)
    ts, td = compact.compact_buckets(torch.from_numpy(st.copy()),
                                     torch.from_numpy(dead_arr.copy()), tm, cb)
    np.testing.assert_array_equal(bits(ts), bits(exp_state))
    np.testing.assert_array_equal(bits(td), bits(exp_dead))


@pytest.mark.parametrize("cb,R,dead_base", CASES)
def test_bucketed_round_trip_equals_port_oracles(cb, R, dead_base):
    """The plain versions against the port's numpy oracles on the states of
    `test_bucketed_round_trip_equals_jax_interpret`, with a zero dead array:
    the kernel zeroes a dead segment's padding lanes, which the oracle
    leaves as they were."""
    rng = np.random.default_rng(cb + R + dead_base)
    st, alive, dead, code = make_state(rng, R, cb)
    dead_arr = np.zeros((8, 2 * R), F32)
    tm, *_ = compact.compact_meta_buckets(
        torch.from_numpy(code), cb, torch.tensor(dead_base, dtype=torch.int32),
        R)
    ts, td = compact.compact_buckets(torch.from_numpy(st.copy()),
                                     torch.from_numpy(dead_arr.copy()), tm, cb)
    os_, od, om, *_ = compact.compact_oracle_buckets(st, dead_arr, cb,
                                                     dead_base)
    np.testing.assert_array_equal(tm.numpy(), om)
    np.testing.assert_array_equal(bits(ts), bits(os_))
    np.testing.assert_array_equal(bits(td), bits(od))
    y = ts[compact.ROW_ACC:].contiguous()
    out = compact.expand_buckets(y, td, torch.from_numpy(code)[None], tm, cb)
    ref = compact.expand_oracle_buckets(y.numpy(), td.numpy(), code, om, cb)
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("name", ["NB", "META9_COLS", "M9_DEAD", "M9_BUSY"])
def test_bucket_constants_equal_jax(name):
    assert getattr(compact, name) == getattr(jcompact, name)
