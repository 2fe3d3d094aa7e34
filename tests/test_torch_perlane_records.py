"""B4's redesign on the CPU: the resident regime's page-major records
(`intersect_perlane.page_records`, which the CUDA kernel reads) against
the per-lane tables they are built from, word for word at every (bank,
page, triangle, feature), -0 and NaN included; the B4 wrapper on CPU
tensors reads the JAX layout only; and the Engine, which now holds the
records, unlit and lit, bitwise against JAX `Engine(interpret=True)` at
48x27."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.ops import intersect_perlane as ip
from rust_raytrace_tpu_torch.ops.pages import build_pages_kd
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_torch_lights import carry

F32 = np.float32
RB = 128
N_INT, N_SHD, GROUP = 17, 7, 128
#: the teapot preset's light (models/teapot.py, with_light=True)
LIGHT = JLightSource(orig=np.asarray([-4.0, 8.0, 0.0], F32), len2=0.2)
#: (sphere lat/lon, page size) -> 1 bank of 13 pages; 2 banks of 174 pages
BANKS = {1: ((8, 12), 16), 2: ((24, 30), 8)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(banks):
    """tests/test_torch_perlane.py's sphere and floor."""
    lat_lon, page = BANKS[banks]
    s = make_sphere((0.0, 0.0, 6.0), 2.0, lat_lon,
                    matte(m3.make_color((200, 60, 60)), 0.3), -1.0)
    floor = make_triangles(
        np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32),
        reflective(m3.make_color((120, 120, 120)), 0.8, 0.1), 0.0)
    return assemble([s, floor]), page


def words(x):
    return x.view(torch.int32)


def _check_records(tabs, P):
    """rec[b*128 + p, j, f] = plt_i[b*17P + f*P + j, p] (f < 17) or
    plt_s[b*7P + (f-17)*P + j, p]; pab = ab's lanes 0..7; by explicit
    indices, independent of page_records' permute."""
    NB = tabs.ab.shape[0] // GROUP
    assert tabs.rec.shape == (NB * GROUP, P, 24)
    assert tabs.pab.shape == (NB * GROUP, 8)
    rec = words(tabs.rec).reshape(NB, GROUP, P, 24)
    wi = words(tabs.plt_i).reshape(NB, N_INT, P, GROUP)
    ws = words(tabs.plt_s).reshape(NB, N_SHD, P, GROUP)
    for f in range(24):
        src = wi[:, f] if f < N_INT else ws[:, f - N_INT]
        assert torch.equal(rec[..., f], src.transpose(1, 2)), f
    assert torch.equal(words(tabs.pab), words(tabs.ab)[:, :8])


@pytest.mark.parametrize("banks", [1, 2])
def test_resident_records_equal_the_tables(banks):
    """The Engine's resident tables and records: every word of the records
    is the per-lane tables' word, and the first pages' records are the
    packed pages' lanes 0..23 (zero past the last page)."""
    scene, page = _scene(banks)
    eng = Engine(carry(scene), page_size=page, ray_chunk=RB,
                 device="cpu")
    tabs = eng.ptables
    assert not eng.streamed and tabs.ab.shape[0] == GROUP * banks
    _check_records(tabs, page)
    NP = eng.pages.num_pages
    np.testing.assert_array_equal(
        words(tabs.rec[:NP]).numpy(),
        eng.pages.PK[:, :, :24].view(np.int32))
    assert not words(tabs.rec[NP:]).any()


def _random_tables(NB, P, seed):
    """Per-lane tables of random words with -0, NaN (quiet and signalling
    payloads), infinities and subnormals scattered in, flat layout."""
    rng = np.random.default_rng(seed)
    specials = np.asarray([0x80000000, 0x7FC00000, 0x7FA00001, 0xFFC12345,
                           0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF],
                          np.uint32)

    def table(rows):
        w = rng.integers(0, 2 ** 32, (rows, GROUP),
                         dtype=np.uint64).astype(np.uint32)
        w.reshape(-1)[rng.integers(0, w.size, 300)] = rng.choice(specials,
                                                                 300)
        return torch.from_numpy(w.view(np.int32)).view(torch.float32)

    return (table(NB * N_INT * P), table(NB * N_SHD * P),
            table(NB * GROUP)), specials


def test_records_keep_minus_zero_and_nan():
    """Word copies: -0, NaN payloads, infinities and subnormals arrive
    unchanged, in the flat resident layout and in the streamed regime's
    [NB, 17P, 128] one alike."""
    NB, P = 3, 8
    (plt_i, plt_s, ab), specials = _random_tables(NB, P, 77)
    tabs = ip.perlane_tables(plt_i, plt_s, ab)
    _check_records(tabs, P)
    assert np.isin(specials.view(np.int32), words(tabs.rec).numpy()).all()
    banked = ip.page_records(plt_i.reshape(NB, N_INT * P, GROUP),
                             plt_s.reshape(NB, N_SHD * P, GROUP), ab)
    for a, b in zip(banked, tabs[3:]):
        assert torch.equal(words(a), words(b))


def test_cpu_wrapper_reads_the_jax_layout():
    """On CPU tensors B4's wrapper takes its plain version, which reads the
    per-lane tables only: records filled with NaN change no bit, unlit and
    lit, and nothing launches."""
    scene, page = _scene(2)
    pages = build_pages_kd(carry(scene).tris, page_size=page)
    tabs = ip.perlane_tables(*ip.upload_perlane_tables(pages, "cpu"))
    bad = tabs._replace(rec=torch.full_like(tabs.rec, float("nan")),
                        pab=torch.full_like(tabs.pab, float("nan")))
    rng = np.random.default_rng(5)
    R = 2 * RB
    st = np.zeros((16, R), F32)
    st[0:3] = rng.uniform([-3, -3, 3], [3, 3, 9], (R, 3)).T
    d = rng.normal(size=(3, R))
    st[3:6] = d / np.linalg.norm(d, axis=0)
    st[6] = 1.0
    st[7] = (rng.uniform(size=R) > 0.2).astype(F32)
    st[11] = 1.0 - st[7]
    state = torch.from_numpy(st)
    live = torch.ones(R // RB, dtype=torch.int32)
    seed = np.asarray([5, 6], np.uint32)
    native.reset_launch_counts()
    for light in (None, (-4.0, 8.0, 0.0, 0.2)):
        a, b = (ip.trace_shade_perlane(state, t, seed, page, RB, False,
                                       1 / 512, live, light)
                for t in (tabs, bad))
        assert torch.equal(words(a), words(b))
        assert not torch.equal(words(a), words(state))
    assert native.TRACE_SHADE_PERLANE.launches == 0


@pytest.fixture(scope="module")
def circles_48x27():
    jscene, vp = jcircles.build(resolution=(48, 27), maxdepth=5)
    return jscene, vp


@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_engine_equals_jax_engine(circles_48x27, lit, fixed_rng):
    """The Engine holding the records (the bounce waves' B4 takes them),
    unlit and lit, fixed and live RNG: float image, u8 image and wave_rays
    bitwise against JAX Engine(interpret=True)."""
    jscene, vp = circles_48x27
    jscene.lights = LIGHT if lit else None
    try:
        ref = JEngine(jscene, ray_chunk=RB, interpret=True).render(
            vp, key=jax.random.PRNGKey(2), fixed_rng=fixed_rng,
            quantize=False)
        eng = Engine(carry(jscene), ray_chunk=RB, device="cpu")
    finally:
        jscene.lights = None
    assert eng.ptables is not None and (eng.light is not None) == lit
    mine = eng.render(vp, key=prng_key(2), fixed_rng=fixed_rng,
                      quantize=False)
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  ref.image.view(np.uint32))
    u8 = eng.render(vp, key=prng_key(2), fixed_rng=fixed_rng).image
    np.testing.assert_array_equal(u8, png.quantize_u8(ref.image))
