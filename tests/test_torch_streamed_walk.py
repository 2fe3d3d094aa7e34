"""B9's walk as the CUDA kernel orders it (csrc/trace_streamed.cu),
emulated on the CPU and held bitwise to the plain versions, and
the plain versions held to the JAX package, on inputs that the new order
must keep exact: a triangle and its copy (equal t, a larger id) in two
banks and two pages, zero-normal slots mid-page, rays from inside the
sphere inside several bank boxes and meeting their winner on the last
bank they visit, a chunk with no live ray whose words hold -0 and NaNs,
and live chunks with dead lanes (alive -0 or +0), at page size 8 and
ray_chunk 1024 (tests/streamed_walk_cases.py, which
tests/test_torch_cuda.py shares).

The emulation: the live list (the valid rays of live chunks that enter a
bank box, by direction octant within a block of 1024 lanes; the rest get
no hit; 16 lanes a ray where most listed rays start outside every bank
box they enter, else 32), the once-a-ray bank list visited in (entry,
bank) order with pruning, the group boxes of 8 pages in front of the page boxes, the pages
in (entry, page) order, and a page's slots split over a group of lanes,
each with its own running best (t first; only a t that could win goes on
to the full test), then the lexicographic (t, id, slot) butterfly.  Its
(t, id) equal `trace_streamed_plain`'s rows bit for bit, and the winning
slot holds the winning id.  The group boxes contain their pages (-0, NaN
and padding bounds included), and B12a's dead-chunk path and mask-word
combination equal `bankmajor_prep_plain`.  The plain B9 equals JAX
`trace_shade_streamed_pallas(interpret=True)` on the same state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.intersect_streamed import (
    build_streamed_tables as jbuild_streamed_tables,
    trace_shade_streamed_pallas)
from rust_raytrace_tpu_torch.ops.cull import slab, slab_inv
from rust_raytrace_tpu_torch.ops.intersect import packed_hit_predicate
from rust_raytrace_tpu_torch.ops.intersect_perlane import GROUP
from rust_raytrace_tpu_torch.ops.intersect_streamed import (
    PAGES_A_BOX, WIN_ID, WIN_SLOT, WIN_T, bankmajor_prep,
    bankmajor_prep_plain, group_boxes, trace_shade_streamed,
    trace_streamed_plain)
from rust_raytrace_tpu_torch.ops.pages import LANE_ID
from rust_raytrace_tpu_torch.utils import native
from streamed_walk_cases import (CAMERA_CHUNK, DEAD_CHUNK, F32, INSIDE_CHUNK,
                                 NC, P, RB, chunk_live, scene, state, tables)

LIST_BLOCK = 1024
NO_KEY = 0x7FFFFFFF


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    pages, src, targets = scene()
    st = state(targets)
    return dict(pages=pages, src=src, st=st,
                cl=chunk_live(st), tabs=tables(pages))


def bits(x):
    return np.asarray(x, F32).view(np.uint32)


def _slab_hit(boxes, o, inv):
    """(tlo, thi, valid) [n_boxes, n_rays] of boxes [n, 8] (lanes 0..2 lo,
    3..5 hi, 6 valid) against rays o/inv [3, n_rays]."""
    tlo, thi = slab([boxes[:, k:k + 1] for k in range(3)],
                    [boxes[:, k + 3:k + 4] for k in range(3)],
                    [o[k][None] for k in range(3)],
                    [inv[k][None] for k in range(3)])
    return tlo, thi, (boxes[:, 6:7] != 0.0).expand_as(tlo)


def _entered(tlo, thi, valid, t_max):
    return valid & (tlo <= thi) & (thi >= 0.0) & (tlo <= t_max)


def _lex_less(t, i, bt, bi):
    return (t < bt) or (t == bt and not np.isinf(t) and i < bi)


def _live_list(st, cl, tabs):
    """The list grid: (the listed lanes in list order, block by block, by
    octant then lane; the lanes it shades with no hit)."""
    R = st.shape[1]
    NB = tabs.plt_i.shape[0]
    o, d = st[0:3], st[3:6]
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    tlo, thi, valid = _slab_hit(tabs.bank_ab[:NB], o, inv)
    enters = (_entered(tlo, thi, valid, torch.inf)
              & (tlo < torch.inf)).any(dim=0)
    live = torch.repeat_interleave(cl != 0, RB)
    queued = live & (st[7] != 0) & enters
    octant = ((d[0] < 0).long() * 4 + (d[1] < 0).long() * 2
              + (d[2] < 0).long())
    order = []
    for b0 in range(0, R, LIST_BLOCK):
        lanes = torch.arange(b0, min(R, b0 + LIST_BLOCK))
        q = lanes[queued[lanes]]
        order.append(q[torch.sort(octant[q], stable=True).indices])
    return torch.cat(order), live & ~queued


def _lanes_a_ray(st, cl, tabs):
    """The list grid's choice of the trace grid's width: 16 lanes a ray
    where more than half the listed rays start outside every bank box they
    enter (no entered box at an entry t <= 0), else 32."""
    NB = tabs.plt_i.shape[0]
    o, d = st[0:3], st[3:6]
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    tlo, thi, valid = _slab_hit(tabs.bank_ab[:NB], o, inv)
    entered = _entered(tlo, thi, valid, torch.inf) & (tlo < torch.inf)
    queued = (torch.repeat_interleave(cl != 0, RB) & (st[7] != 0)
              & entered.any(dim=0))
    outside = queued & ~(entered & (tlo <= 0)).any(dim=0)
    return 16 if 2 * int(outside.sum()) > int(queued.sum()) else 32


def _terms(st, tabs):
    """Every ray's slab tests (tlo, thi, valid) of the bank, page and group
    boxes, and t, ok and id [slots, R] of every (record slot, ray) pair as
    the plain versions' predicate rounds them; numpy."""
    o, d = st[0:3], st[3:6]
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    NB = tabs.plt_i.shape[0]
    out = {name: tuple(x.numpy() for x in _slab_hit(boxes, o, inv))
           for name, boxes in (("bank", tabs.bank_ab[:NB]),
                               ("page", tabs.pab), ("group", tabs.gab))}
    rec = tabs.rec.reshape(-1, tabs.rec.shape[-1])
    R = st.shape[1]
    t = np.empty((rec.shape[0], R), F32)
    ok = np.empty((rec.shape[0], R), bool)
    for i in range(0, R, 512):
        sl = slice(i, i + 512)
        tt, kk, _, _, _ = packed_hit_predicate(
            lambda f: rec[:, f:f + 1], tuple(o[k, sl][None] for k in range(3)),
            tuple(d[k, sl][None] for k in range(3)))
        t[:, sl], ok[:, sl] = tt.numpy(), kk.numpy()
    out["hit"] = (t, ok, rec[:, LANE_ID].numpy())
    return out


def _walk(r, terms, NB, G, cull):
    """The trace grid's walk of ray r by a group of G lanes: (t, id,
    winner page, winner slot, banks visited, the winner's bank)."""
    def entered(name, i, t_max):
        tlo, thi, val = (x[i, r] for x in terms[name])
        return bool(val and tlo <= thi and thi >= 0.0 and tlo <= t_max)

    btlo, ptlo = terms["bank"][0][:, r], terms["page"][0][:, r]
    t_all, ok_all, id_all = terms["hit"]
    wt, wid, wpage, wj = np.float32(np.inf), np.float32(0.0), -1, 0
    visited, win_bank = [], -1
    # one set of bits for every bank (MAX_STREAMED_BANKS over the lanes)
    todo = {b for b in range(NB) if entered("bank", b, wt)
            and btlo[b] < np.inf}
    while True:
        todo = {b for b in todo if btlo[b] <= wt}
        if not todo:
            break
        b = min(todo, key=lambda x: (btlo[x], x))
        todo.discard(b)
        visited.append(b)
        pin = [entered("page", b * GROUP + i, wt) for i in range(GROUP)]
        if cull:
            gin = [entered("group", b * GROUP // PAGES_A_BOX + k, wt)
                   for k in range(GROUP // PAGES_A_BOX)]
            # a page that passes passes its group box
            assert all(gin[i // PAGES_A_BOX] for i in range(GROUP) if pin[i])
            pin = [pin[i] and gin[i // PAGES_A_BOX] for i in range(GROUP)]
        ptl = {i: ptlo[b * GROUP + i] for i in range(GROUP) if pin[i]}
        while ptl:
            kp = min(ptl, key=lambda x: (ptl[x], x))
            if ptl.pop(kp) > wt:
                break
            page = b * GROUP + kp
            lanes = []
            for gl in range(G):
                lt, lid, lj = wt, wid, NO_KEY
                for j in range(gl, P, G):
                    s = page * P + j
                    t = t_all[s, r]
                    if not (t >= 0 and (t < lt or (t == lt
                                                   and not np.isinf(t)))):
                        continue
                    if ok_all[s, r] and _lex_less(t, id_all[s], lt, lid):
                        lt, lid, lj = t, id_all[s], j
                lanes.append((lt, lid, lj))
            m = G // 2
            while m >= 1:
                nxt = []
                for gl in range(G):
                    a, c = lanes[gl], lanes[gl ^ m]
                    take = _lex_less(c[0], c[1], a[0], a[1]) or (
                        c[0] == a[0] and c[1] == a[1] and c[2] < a[2])
                    nxt.append(c if take else a)
                lanes = nxt
                m //= 2
            assert len(set(map(repr, lanes))) == 1        # every lane agrees
            if lanes[0][2] != NO_KEY:
                wt, wid, wj = lanes[0]
                wpage, win_bank = page, b
    return wt, wid, wpage, wj, visited, win_bank


@pytest.fixture(scope="module")
def terms(case):
    return _terms(torch.from_numpy(case["st"]), case["tabs"])


@pytest.mark.parametrize("lanes,cull", [(16, True), (4, True), (16, False),
                                        (32, True)])
def test_walk_order_equals_plain(case, terms, lanes, cull):
    """The kernel's list and walk order, emulated at `lanes` lanes a ray
    (32 and 16, the kernel's two widths; 4, so that a lane's running best
    and the butterfly's ties see several slots) with and without the group
    boxes:
    (t, id) bitwise the plain version's, the winning slot holding the
    winning id; the rays left off the list have no hit."""
    tabs = case["tabs"]
    st = torch.from_numpy(case["st"])
    cl = torch.from_numpy(case["cl"])
    rows = trace_streamed_plain(st[0:3], st[3:6], st[7], tabs, P, RB, cl)
    order, shaded = _live_list(st, cl, tabs)
    assert torch.equal(torch.sort(order).values,
                       torch.nonzero(~shaded & (torch.repeat_interleave(
                           cl != 0, RB)) & (st[7] != 0)).squeeze(1))
    valid = (st[7] != 0) & torch.repeat_interleave(cl != 0, RB)
    off = shaded & valid
    assert off.any() and (rows[0, off] == torch.inf).all()
    assert (rows[1, shaded] == 0).all()
    NB = tabs.plt_i.shape[0]
    rec_id = tabs.rec[..., LANE_ID].reshape(-1)
    got_t, got_id = rows[0].clone(), rows[1].clone()
    multi_bank = last_bank = 0
    for r in order.tolist():
        wt, wid, wpage, wj, visited, win_bank = _walk(r, terms, NB, lanes,
                                                      cull)
        got_t[r], got_id[r] = float(wt), float(wid)
        if wid != 0:
            assert rec_id[wpage * P + wj] == wid
            last_bank += len(visited) > 1 and win_bank == visited[-1]
        o = st[0:3, r:r + 1]
        bb = tabs.bank_ab[:NB]
        inside = ((bb[:, 0:3] <= o[:, 0]) & (o[:, 0] <= bb[:, 3:6])).all(1)
        multi_bank += int(inside.sum()) >= 2
    np.testing.assert_array_equal(bits(got_t), bits(rows[0]))
    np.testing.assert_array_equal(bits(got_id), bits(rows[1]))
    assert multi_bank > 100 and last_bank > 10
    # ties: rays aimed at a copied triangle meet it and its copy at one t;
    # the original (smaller id) wins where both pages are visited, the copy
    # where its bank comes first and the original's page box rounds its
    # entry past that t (pruned, in the plain version as in JAX)
    src = torch.from_numpy(case["src"].astype(F32))
    assert torch.isin(rows[1, :64], src).sum() >= 32


def test_list_chooses_lanes(case):
    """The width the list grid picks: 16 lanes a ray for the camera rays'
    chunk alone (every listed ray starts outside the sphere's bank boxes),
    32 for the chunk of rays from inside the sphere (each starts inside a
    bank box it enters); the choice changes no bit (the walk's emulation
    at both widths above)."""
    st = torch.from_numpy(case["st"])
    tabs = case["tabs"]
    for keep, want in ((CAMERA_CHUNK, 16), (INSIDE_CHUNK, 32)):
        cl = (torch.arange(NC) == keep).to(torch.int32)
        assert _lanes_a_ray(st, cl, tabs) == want


def test_group_boxes_contain_their_pages():
    """Every page box whose slab test passes passes its group box's, on
    random rays and boxes (lo <= hi, as every page of the tables) with -0,
    +0 and NaN bounds and invalid padding pages,
    under both min/max semantics (torch.minimum, the plain versions';
    torch.fmin, CUDA's fminf, which drops a NaN); each valid page's bounds
    lie within its group's."""
    rng = np.random.default_rng(5)
    n_pages = 64 * PAGES_A_BOX
    lo = rng.normal(size=(n_pages, 3)).astype(F32)
    hi = lo + rng.uniform(0, 1, (n_pages, 3)).astype(F32)
    # zero bounds of both signs where the box stays a box (lo <= hi)
    zl = (rng.uniform(size=(n_pages, 3)) < 0.1) & (hi >= 0)
    zh = (rng.uniform(size=(n_pages, 3)) < 0.1) & (lo <= 0)
    lo[zl] = np.where(rng.uniform(size=int(zl.sum())) < 0.5, -0.0, 0.0)
    hi[zh] = np.where(rng.uniform(size=int(zh.sum())) < 0.5, -0.0, 0.0)
    lo[rng.uniform(size=(n_pages, 3)) < 0.02] = np.nan
    hi[rng.uniform(size=(n_pages, 3)) < 0.02] = np.nan
    valid = rng.uniform(size=n_pages) < 0.8
    valid[:PAGES_A_BOX] = False                  # a group of padding only
    pab = np.zeros((n_pages, 8), F32)
    pab[:, 0:3], pab[:, 3:6], pab[:, 6] = lo, hi, valid
    pab[~valid, 0:3], pab[~valid, 3:6] = np.inf, -np.inf
    pab = torch.from_numpy(pab)
    gab = group_boxes(pab)
    assert gab.shape == (n_pages // PAGES_A_BOX, 8) and (gab[:, 7] == 0).all()
    assert not bool(gab[0, 6]) and bool(gab[1:, 6].all())
    g = torch.arange(n_pages) // PAGES_A_BOX
    v = torch.from_numpy(valid)
    num = ~torch.isnan(pab[:, 0:6])
    assert (gab[g][v][:, 0:3][num[v][:, 0:3]]
            <= pab[v][:, 0:3][num[v][:, 0:3]]).all()
    assert (gab[g][v][:, 3:6][num[v][:, 3:6]]
            >= pab[v][:, 3:6][num[v][:, 3:6]]).all()
    n = 4096
    o = torch.from_numpy(rng.normal(size=(3, n)).astype(F32) * 1.5)
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(F32))
    d[0, :64] = 0.0
    d[1, 64:128] = -0.0
    d[2, 128:160] = 1e-42                          # a subnormal: inv = inf
    o[:, 160:192] = pab[8:40, 0:3].T.nan_to_num(0.0)    # on a box's corner
    o[:, 192:224] = 0.0                                 # on the zero bounds
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    for lo_fn, hi_fn in ((torch.minimum, torch.maximum),
                         (torch.fmin, torch.fmax)):
        def test(boxes):
            tlo = thi = None
            for k in range(3):
                t1 = (boxes[:, k:k + 1] - o[k][None]) * inv[k][None]
                t2 = (boxes[:, k + 3:k + 4] - o[k][None]) * inv[k][None]
                a, b = lo_fn(t1, t2), hi_fn(t1, t2)
                tlo = a if tlo is None else hi_fn(tlo, a)
                thi = b if thi is None else lo_fn(thi, b)
            return ((boxes[:, 6:7] != 0) & (tlo <= thi) & (thi >= 0.0))

        page_in, group_in = test(pab), test(gab)
        assert page_in.any()
        assert not (page_in & ~group_in[g]).any()


def test_group_boxes_of_the_tables(case):
    """upload_streamed_tables' group boxes are group_boxes of its page
    boxes, and each valid page lies within its group's box."""
    tabs = case["tabs"]
    assert torch.equal(tabs.gab.view(torch.int32),
                       group_boxes(tabs.pab).view(torch.int32))
    g = torch.arange(tabs.pab.shape[0]) // PAGES_A_BOX
    v = tabs.pab[:, 6] != 0
    assert (tabs.gab[g][v][:, 0:3] <= tabs.pab[v][:, 0:3]).all()
    assert (tabs.gab[g][v][:, 3:6] >= tabs.pab[v][:, 3:6]).all()
    assert ((tabs.gab[:, 6] != 0)
            == v.reshape(-1, PAGES_A_BOX).any(dim=1)).all()


def _jax_tables(pages):
    return tuple(map(jnp.asarray, jbuild_streamed_tables(pages)))


@pytest.mark.parametrize("fixed_rng", [True, False])
@pytest.mark.parametrize("flags", ["live", "all"])
def test_trace_shade_streamed_equals_jax(case, fixed_rng, flags):
    """The port's B9 (on the CPU its plain version) against JAX
    `trace_shade_streamed_pallas(interpret=True)`, bitwise: chunk_live as
    the state says (the dead chunk passed through, its -0 and NaN words
    kept) and every chunk flagged live."""
    st = case["st"]
    cl = case["cl"] if flags == "live" else np.ones(NC, np.int32)
    seed = np.asarray([321, 654], np.uint32)
    wc = 0.0 if fixed_rng else 1 / 512
    ref = np.asarray(trace_shade_streamed_pallas(
        jnp.asarray(st), *_jax_tables(case["pages"]), jnp.asarray(seed), P,
        RB, fixed_rng=fixed_rng, weight_cutoff=wc,
        chunk_live=jnp.asarray(cl), interpret=True))
    native.reset_launch_counts()
    mine = trace_shade_streamed(torch.from_numpy(st), case["tabs"], seed, P,
                                RB, fixed_rng, wc,
                                torch.from_numpy(cl)).numpy()
    assert native.TRACE_SHADE_STREAMED.launches == 0   # CPU: plain version
    np.testing.assert_array_equal(bits(mine), bits(ref))
    dead = slice(DEAD_CHUNK * RB, (DEAD_CHUNK + 1) * RB)
    if flags == "live":
        np.testing.assert_array_equal(bits(mine[:, dead]), bits(st[:, dead]))
    assert (mine[7, 2 * RB:] != st[7, 2 * RB:]).any()


def _prep_emulated(st, bank_ab, NB, cl):
    """B12a as the kernel computes it: a dead chunk's winner init (-inf, 0,
    0) and zero gm words without reading its rows; in a live chunk each
    valid ray's bank bits, 32 banks a word, ORed over each warp of 32
    lanes, then a 128-lane group's four warps' words combined into bit g
    of each bank's gm word."""
    R = st.shape[1]
    win = np.zeros((3, R), F32)
    gm = np.zeros((NB, R // RB), np.int32)
    o, d = torch.from_numpy(st[0:3]), torch.from_numpy(st[3:6])
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    tlo, thi, valid = _slab_hit(bank_ab[:NB], o, inv)
    hit = _entered(tlo, thi, valid, torch.inf).numpy()     # [NB, R]
    for c in range(R // RB):
        lanes = slice(c * RB, (c + 1) * RB)
        if cl[c] == 0:
            win[0, lanes] = -np.inf
            continue
        ok = st[7, lanes] != 0
        win[0, lanes] = np.where(ok, np.inf, -np.inf)
        h = hit[:, lanes] & ok[None]                       # [NB, RB]
        words = h.reshape(NB, RB // 32, 32).any(axis=2)     # warp ORs
        groups = words.reshape(NB, RB // GROUP, 4).any(axis=2)
        gm[:, c] = (groups * (1 << np.arange(RB // GROUP))).sum(axis=1)
    return win, gm


def test_bankmajor_prep_dead_chunk(case):
    """B12a on the walk's state (chunk DEAD_CHUNK flagged dead): the
    kernel's dead-chunk path and mask-word combination, emulated, equal
    bankmajor_prep_plain word for word, as does the wrapper on the CPU."""
    tabs = case["tabs"]
    st = case["st"]
    cl = case["cl"]
    assert cl[DEAD_CHUNK] == 0
    NB = tabs.plt_i.shape[0]
    args = (torch.from_numpy(st), tabs.bank_ab, NB, RB, torch.from_numpy(cl))
    win_p, gm_p = bankmajor_prep_plain(*args)
    win_w, gm_w = bankmajor_prep(*args)
    win_e, gm_e = _prep_emulated(st, tabs.bank_ab, NB, cl)
    for win, gm in ((win_w, gm_w), (torch.from_numpy(win_e),
                                    torch.from_numpy(gm_e))):
        np.testing.assert_array_equal(bits(win), bits(win_p))
        np.testing.assert_array_equal(gm.numpy(), gm_p.numpy())
    assert (gm_p[:, DEAD_CHUNK] == 0).all() and (gm_p != 0).any()
    dead = slice(DEAD_CHUNK * RB, (DEAD_CHUNK + 1) * RB)
    assert (win_p[WIN_T, dead] == -torch.inf).all()
    assert (win_p[WIN_ID, dead] == 0).all() and (win_p[WIN_SLOT] == 0).all()
