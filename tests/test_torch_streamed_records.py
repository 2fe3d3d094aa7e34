"""The streamed regime's page-major records (`page_records`, read by
the CUDA walks of B9, B10 and B12's sweep) against the JAX-layout tables
they are built from, word for word at every (bank, page, triangle,
feature): on tests/test_torch_streamed.py's 4-bank sphere (page size 8),
on test_torch_streamed_lit.py's seed-137 multi-bank soup, and on tables
holding -0 and NaN words.  The CPU paths of the wrappers read the JAX
layout only, and still return the JAX package's bits through the tables
object."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.ops.intersect_streamed import (
    build_streamed_tables as jbuild_streamed_tables, trace_streamed_pallas)
from rust_raytrace_tpu.ops.pages import build_pages_kd as jbuild_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.ops import intersect_streamed as st_
from rust_raytrace_tpu_torch.ops.intersect_perlane import page_records
from rust_raytrace_tpu_torch.ops.pages import build_pages_kd
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)

F32 = np.float32
P = 8
RB = 128
N_INT, N_SHD, GROUP = 17, 7, 128


def carry(jscene):
    t = jscene.tris
    fields = {k: getattr(t, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(t.materials, k) for k in MATERIAL_FIELDS})
    return scene_from_arrays(fields)


def sphere():
    """tests/test_torch_streamed.py's sphere: 4 banks at P = 8."""
    return assemble([make_sphere((0.0, 0.0, 6.0), 2.5, (40, 40),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.0)])


def _rand_surface(rng):
    color = m3.make_color(tuple(int(c) for c in rng.integers(10, 255, 3)))
    kind = rng.integers(0, 3)
    if kind == 0:
        return solid(color)
    if kind == 1:
        return matte(color, float(rng.uniform(0.05, 0.6)))
    return reflective(color, float(rng.uniform(0.1, 0.7)),
                      float(rng.uniform(0.0, 0.25)))


def soup():
    """test_torch_streamed_lit.py's seed-137 scene: two soups and a 22x26
    sphere, 2 banks at P = 8."""
    rng = np.random.default_rng(137)
    parts = []
    for _ in range(2):
        n = int(rng.integers(4, 14))
        pts = (rng.uniform(-1.0, 1.0, (n, 3, 3)).astype(F32) * F32(0.35)
               + rng.uniform(-2.5, 2.5, (n, 1, 3)).astype(F32)
               + np.asarray([0, 0, 8], F32))
        parts.append(make_triangles(pts, _rand_surface(rng),
                                    float(rng.uniform(0.0, 0.1))))
    orig = rng.uniform(-2, 2, 3).astype(F32) + np.asarray([0, 0, 8], F32)
    parts.append(make_sphere(tuple(orig), float(rng.uniform(0.8, 2.0)),
                             (22, 26), _rand_surface(rng),
                             float(rng.uniform(0.0, 0.08))))
    return assemble(parts)


SCENES = {"sphere": sphere, "soup": soup}


@pytest.fixture(scope="module", params=sorted(SCENES))
def built(request):
    """(the port's pages, its tables on the CPU, JAX's tables) of a
    scene."""
    jscene = SCENES[request.param]()
    pages = build_pages_kd(carry(jscene).tris, page_size=P)
    ref = jbuild_streamed_tables(jbuild_pages_kd(jscene.tris, page_size=P))
    return pages, st_.upload_streamed_tables(pages, "cpu"), ref


def words(x):
    return np.asarray(x).view(np.uint32) if isinstance(x, np.ndarray) \
        else x.view(torch.int32).numpy().view(np.uint32)


def _check_records(plt_i, plt_s, ab, rec, pab):
    """rec/pab hold exactly the words of plt_i/plt_s/ab, by a loop over
    banks and features independent of page_records' permute."""
    wi, ws, wa = words(plt_i), words(plt_s), words(ab)
    wr, wp = words(rec), words(pab)
    NB = wi.shape[0]
    assert wr.shape == (NB * GROUP, P, N_INT + N_SHD)
    assert wp.shape == (NB * GROUP, 8)
    for b in range(NB):
        for f in range(N_INT + N_SHD):
            src = (wi[b, f * P:(f + 1) * P] if f < N_INT
                   else ws[b, (f - N_INT) * P:(f - N_INT + 1) * P])   # [P, 128]
            np.testing.assert_array_equal(
                wr[b * GROUP:(b + 1) * GROUP, :, f], src.T)
    np.testing.assert_array_equal(wp, wa[:, :8])


def test_records_equal_tables(built):
    """Every (bank, page, triangle, feature) word; the pages past the
    scene's (the last bank's padding) are zero records with an invalid
    box; the records are the pages' packed lanes 0..23."""
    pages, tabs, ref = built
    for mine, want in zip(tabs[:4], ref):
        np.testing.assert_array_equal(words(mine), words(want))
    _check_records(*tabs[:3], tabs.rec, tabs.pab)
    NP = pages.num_pages
    NB = tabs.plt_i.shape[0]
    assert NB >= 2 and NP < NB * GROUP
    np.testing.assert_array_equal(words(tabs.rec[:NP]),
                                  words(pages.PK[:, :, :24]))
    assert (words(tabs.rec[NP:]) == 0).all()
    assert (tabs.pab[NP:] == 0).all() and (tabs.pab[:NP, 6] == 1).all()
    assert (tabs.pab[:, 7] == 0).all()
    # bank_ab's padding rows (banks NB..NB8) are zero, lane 6 invalid
    assert tabs.bank_ab.shape[0] % 8 == 0
    assert (tabs.bank_ab[NB:] == 0).all()


def test_records_keep_negative_zero_and_nan_bits():
    """Words that a float copy could change (-0, quiet and signalling NaNs
    with payloads, subnormals, infinities) reach the records unchanged."""
    NB, specials = 3, np.asarray([0x80000000, 0x7FC12345, 0x7F812345,
                                  0xFFC00001, 0x00000001, 0x807FFFFF,
                                  0x7F800000, 0xFF800000], np.uint32)
    rng = np.random.default_rng(5)

    def table(rows):
        w = rng.integers(0, 2 ** 32, (NB, rows, GROUP), dtype=np.uint64)
        w = w.astype(np.uint32)
        w.reshape(-1)[rng.integers(0, w.size, 400)] = rng.choice(specials,
                                                                 400)
        return torch.from_numpy(w.view(np.int32)).view(torch.float32)

    plt_i, plt_s = table(N_INT * P), table(N_SHD * P)
    ab = table(GROUP).reshape(NB * GROUP, GROUP)
    rec, pab = page_records(plt_i, plt_s, ab)
    assert rec.dtype == pab.dtype == torch.float32
    _check_records(plt_i, plt_s, ab, rec, pab)
    assert np.isin(specials, words(rec)).all()


def test_cpu_wrappers_read_the_jax_layout(built):
    """On CPU tensors every wrapper takes its plain version, which reads
    the JAX layout only: records filled with NaN change no bit, and B10's
    rows equal the JAX kernel's in interpret mode."""
    _, tabs, ref = built
    bad = tabs._replace(rec=torch.full_like(tabs.rec, float("nan")),
                        pab=torch.full_like(tabs.pab, float("nan")))
    rng = np.random.default_rng(3)
    R = 2 * RB
    o = (rng.normal(size=(3, R)) * 0.5).astype(F32) + np.asarray(
        [[0], [0], [1]], F32)
    d = rng.normal(size=(3, R)).astype(F32) * 0.5 + np.asarray(
        [[0], [0], [1]], F32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = np.ones(R, F32)
    ot, dt, at = map(torch.from_numpy, (o, d, alive))
    rows = st_.trace_streamed(ot, dt, at, tabs, P, RB)
    assert torch.equal(rows.view(torch.int32),
                       st_.trace_streamed(ot, dt, at, bad, P,
                                          RB).view(torch.int32))
    want = np.asarray(trace_streamed_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
        *map(jnp.asarray, ref), P, RB, interpret=True))
    np.testing.assert_array_equal(words(rows), words(want))
    assert (want[1] != 0).any()
    st = torch.zeros((16, R))
    st[0:3], st[3:6], st[6], st[7] = ot, dt, 1.0, 1.0
    seed = np.asarray([1, 2], np.uint32)
    live = torch.ones(R // RB, dtype=torch.int32)
    for fn in (st_.trace_shade_streamed, st_.trace_shade_bankmajor):
        a = fn(st, tabs, seed, P, RB, False, 1 / 512, live)
        b = fn(st, bad, seed, P, RB, False, 1 / 512, live)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
