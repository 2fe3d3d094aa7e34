"""B4: per-lane (per-ray) page traversal fused with the shade — bounce waves.

Counterparts in `rust_raytrace_tpu/ops/intersect_perlane.py`:
`build_perlane_tables` (copied: the JAX module imports jax),
`trace_shade_perlane_pallas` (inner `_kernel_fused`, `_trace_chunk`,
`_group`), with its fused shadow feeler (`light=`), and the any-hit mode of
`trace_perlane_pallas` that the feeler runs.  `trace_shade_perlane` runs the
CUDA kernel `csrc/trace_shade_perlane.cu` on CUDA tensors and
`trace_shade_perlane_plain` on CPU tensors.

Each ray slab-tests the page AABBs of one bank (<= 128 pages) at a time,
tests its nearest remaining page (ties to the lower page index), then drops
every page whose entry lies beyond its best hit; the cut carries across
banks.  That is the visit order of the TPU kernel's one-page-per-step loop,
to which its two-pages-per-step form is equal.
"""

import numpy as np
import torch

from ..utils import native, xla_rsqrt
from .cull import slab, slab_inv
from .pages import PACK_LANES, PageTables
from .intersect import (PAYLOAD_ROWS, lex_update, packed_hit_predicate,
                        payload_features)
from .shade import (fma, norm2, rsqrt, scatter_rv, shade_state_rows,
                    shadow_uvs)
from .state import (ROW_ALIVE, ROW_ENC, ROW_ID, ROW_NORM, ROW_T, STATE_ROWS,
                    TRACE_ROWS)

GROUP = 128           # pages per bank
N_INT = 17            # intersect features: n(3) s0..s2(9) nc(1) s*c(3) id(1)
N_SHD = 7             # shade features: et kind color(3) alpha scat
MAX_BANKS = 16

#: rays a plain-version block holds (its gathered tables are 17*P per ray)
_PLAIN_RAYS = 8192


def build_perlane_tables(pages: PageTables):
    """Rearrange PK [NP, P, 128] into pages-on-lanes tables.

    Pages are grouped into NB = ceil(NP/128) banks of <= 128 pages.  Returns
    numpy (PLT_I [NB*N_INT*P, 128], PLT_S [NB*N_SHD*P, 128], AB [NB*128,
    128]): feature f of triangle j of bank-local page p sits at row
    b*N*P + f*P + j, column p; AB rows b*128..b*128+127 hold bank b's page
    AABBs (lanes 0..2 lo, 3..5 hi, 6 page-valid).
    """
    PK = pages.PK
    NP, P, _ = PK.shape
    NB = -(-NP // GROUP)
    assert NB <= MAX_BANKS, \
        f"per-lane traversal caps at {MAX_BANKS * GROUP} pages, got {NP}"

    plt_i = np.zeros((NB * N_INT * P, GROUP), np.float32)
    plt_s = np.zeros((NB * N_SHD * P, GROUP), np.float32)
    ab = np.zeros((NB * GROUP, PACK_LANES), np.float32)

    def table(pk_b, lane0, nf):
        npb = pk_b.shape[0]
        t = np.transpose(pk_b[:, :, lane0:lane0 + nf], (2, 1, 0))
        return t.reshape(nf * P, npb)

    for b in range(NB):
        pk_b = PK[b * GROUP:(b + 1) * GROUP]
        npb = pk_b.shape[0]
        plt_i[b * N_INT * P:(b + 1) * N_INT * P, :npb] = table(pk_b, 0, N_INT)
        plt_s[b * N_SHD * P:(b + 1) * N_SHD * P, :npb] = \
            table(pk_b, N_INT, N_SHD)
        ab[b * GROUP:b * GROUP + npb, 0:3] = \
            pages.aabb_lo[b * GROUP:b * GROUP + npb]
        ab[b * GROUP:b * GROUP + npb, 3:6] = \
            pages.aabb_hi[b * GROUP:b * GROUP + npb]
        ab[b * GROUP:b * GROUP + npb, 6] = 1.0
    return plt_i, plt_s, ab


def upload_perlane_tables(pages: PageTables, device):
    """`build_perlane_tables` as float32 tensors on `device`."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in build_perlane_tables(pages))


def trace_perlane_plain(o, d, alive, plt_i, plt_s, ab, P: int, excl=None,
                        any_hit: bool = False):
    """Winner rows [16, n] (ROW_* layout) of rays o/d [3, n] with alive [n]:
    the per-lane trace alone, plain torch (JAX: trace_perlane_pallas).

    excl: optional [n] triangle id each ray may not hit (0: none).
    any_hit: the occlusion query — each ray tests its slab-hit pages in
    index order and stops at its first page with a hit, so only
    ROW_ID != 0 ("some triangle hits") is meaningful (ROADMAP C5)."""
    n = o.shape[1]
    dev = o.device
    NB = plt_i.shape[0] // (N_INT * P)
    valid = alive != 0.0
    best_t = torch.where(valid, torch.inf, -torch.inf)
    best_id = torch.zeros(n, dtype=torch.float32, device=dev)
    payload = torch.zeros((len(PAYLOAD_ROWS), n), dtype=torch.float32,
                          device=dev)
    inv = [slab_inv(d[k]) for k in range(3)]
    pages = torch.arange(GROUP, dtype=torch.float32, device=dev)[:, None]
    for b in range(NB):
        abb = ab[b * GROUP:(b + 1) * GROUP]
        tlo, thi = slab([abb[:, k:k + 1] for k in range(3)],
                        [abb[:, k + 3:k + 4] for k in range(3)],
                        [o[k][None] for k in range(3)],
                        [inv[k][None] for k in range(3)])   # [128, n]
        hit = ((tlo <= thi) & (thi >= 0.0) & valid[None]
               & (abb[:, 6:7] != 0.0))
        if any_hit:
            hit &= (best_id == 0.0)[None]
        tab_i = plt_i[b * N_INT * P:(b + 1) * N_INT * P].reshape(N_INT, P,
                                                                 GROUP)
        tab_s = plt_s[b * N_SHD * P:(b + 1) * N_SHD * P].reshape(N_SHD, P,
                                                                 GROUP)
        while True:
            if any_hit:
                # occlusion: any order works; the lowest page index first
                lanes = torch.nonzero(hit.any(dim=0)).squeeze(1)
                if lanes.numel() == 0:
                    break
                pidx = torch.where(hit[:, lanes], pages,
                                   float(GROUP)).amin(dim=0).long()
            else:
                hit &= tlo <= best_t[None]
                tkey = torch.where(hit, tlo, torch.inf)
                kmin = tkey.amin(dim=0)
                lanes = torch.nonzero(kmin < torch.inf).squeeze(1)
                if lanes.numel() == 0:
                    break
                pidx = torch.where(tkey[:, lanes] == kmin[lanes], pages,
                                   float(GROUP)).amin(dim=0).long()
            gi = tab_i[:, :, pidx]                       # [17, P, m]
            gs = tab_s[:, :, pidx]                       # [7, P, m]

            def col(f, gi=gi, gs=gs):
                return gi[f] if f < N_INT else gs[f - N_INT]

            o3 = tuple(o[k, lanes][None] for k in range(3))
            d3 = tuple(d[k, lanes][None] for k in range(3))
            t, ok, ids, md_n, dv = packed_hit_predicate(
                col, o3, d3, excl=None if excl is None else excl[lanes][None])
            tt = torch.where(ok, t, torch.inf)
            bt, bi = best_t[lanes], best_id[lanes]
            upd, gmin, gid, onehot = lex_update(tt, ids, bt, bi, dim=0)
            w = onehot.float()
            for i, v in enumerate(payload_features(col, md_n, dv)):
                payload[i, lanes] = torch.where(upd, (w * v).sum(dim=0),
                                                payload[i, lanes])
            best_t[lanes] = torch.where(upd, gmin, bt)
            best_id[lanes] = torch.where(upd, gid, bi)
            hit[pidx, lanes] = False
            if any_hit:
                hit[:, lanes[best_id[lanes] != 0.0]] = False
    rows = torch.zeros((TRACE_ROWS, n), dtype=torch.float32, device=dev)
    rows[ROW_T] = best_t
    rows[ROW_ID] = best_id
    for i, r in enumerate(PAYLOAD_ROWS):
        rows[r] = payload[i]
    return rows


def shadow_feeler_plain(st, rows, seed, rays, ray_chunk: int,
                        fixed_rng: bool, light, plt_i, plt_s, ab, P: int):
    """The fused shadow feeler of the rays at global positions `rays`:
    st/rows [16, n] their state and winner rows; light (ox, oy, oz, len2).
    Returns the [n] float32 shadow mask (1: a hit point that another
    triangle hides from its jittered point on the light).

    Mirrors the JAX `_kernel_fused`'s has_lights block with XLA's
    contractions (ROADMAP C7): p = fma(t, d, o), a = fma(u3, len2, l) - p,
    the sum of squares `norm2`, so = fma(nf, 0.005*(u1 + 1), p); under
    fixed_rng XLA vectorizes the rsqrt's fusion 16 wide (`rsqrt(wide=)`)."""
    hitm = (st[ROW_ALIVE] != 0.0) & (rows[ROW_ID] != 0.0)
    tm = torch.where(hitm, rows[ROW_T], 0.0)
    p = [fma(tm, st[3 + k], st[k]) for k in range(3)]
    back = rows[ROW_ENC] >= 8.0
    nf = [torch.where(back, -rows[ROW_NORM + k], rows[ROW_NORM + k])
          for k in range(3)]
    u3, u1 = shadow_uvs(seed, rays, ray_chunk, fixed_rng)
    lx, ly, lz, l2 = (float(x) for x in light)
    a = [fma(u3[k], l2, lk) - p[k] for k, lk in enumerate((lx, ly, lz))]
    inv = rsqrt(norm2(*a), wide=fixed_rng)
    off = 0.005 * (u1 + 1.0)
    so = torch.stack([torch.where(hitm, fma(nf[k], off, p[k]), 0.0)
                      for k in range(3)])
    sd = torch.stack([torch.where(hitm, a[k] * inv, 0.0) for k in range(3)])
    excl = torch.where(hitm, rows[ROW_ID], 0.0)
    srows = trace_perlane_plain(so, sd, hitm.float(), plt_i, plt_s, ab, P,
                                excl=excl, any_hit=True)
    return (hitm & (srows[ROW_ID] != 0.0)).float()


def trace_shade_perlane_plain(state, plt_i, plt_s, ab, seed, page_size: int,
                              ray_chunk: int, fixed_rng: bool,
                              weight_cutoff: float, chunk_live, light=None):
    """Plain torch version of `trace_shade_perlane`."""
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    for i in range(0, rays.numel(), _PLAIN_RAYS):
        idx = rays[i:i + _PLAIN_RAYS]
        st = state[:, idx]
        rows = trace_perlane_plain(st[0:3], st[3:6], st[ROW_ALIVE], plt_i,
                                   plt_s, ab, page_size)
        shd = None
        if light is not None:
            shd = shadow_feeler_plain(st, rows, seed, idx, ray_chunk,
                                      fixed_rng, light, plt_i, plt_s, ab,
                                      page_size)
        rv = scatter_rv(seed, idx, ray_chunk, fixed_rng)
        out[:, idx] = shade_state_rows(st, rows, rv, weight_cutoff, shd)
    return out


def trace_shade_perlane(state, plt_i, plt_s, ab, seed, page_size: int,
                        ray_chunk: int, fixed_rng: bool, weight_cutoff: float,
                        chunk_live, light=None):
    """One bounce wave: per-ray trace, shade and state update.

    state: [16, R] float32 ray state (ops/state.py); plt_i/plt_s/ab: the
    per-lane tables (upload_perlane_tables); seed: the wave's two uint32 key
    words; ray_chunk: the RNG chunk width (scatter_rv); chunk_live: [NC]
    int32 flags — chunks flagged 0 hold no live ray and pass their state
    through; light: optional (ox, oy, oz, len2) of the scene's light, which
    runs the shadow feeler between trace and shade.  Returns the new state.
    """
    dev = state.device
    if dev.type == "cpu":
        return trace_shade_perlane_plain(state, plt_i, plt_s, ab, seed,
                                         page_size, ray_chunk, fixed_rng,
                                         weight_cutoff, chunk_live, light)
    native.require(dev.type == "cuda",
                   f"trace_shade_perlane: no kernel for device {dev}")
    R = state.shape[1]
    P = page_size
    NB = ab.shape[0] // GROUP
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("plt_i", plt_i, dev, (NB * N_INT * P, GROUP),
                        torch.float32)
    native.check_tensor("plt_s", plt_s, dev, (NB * N_SHD * P, GROUP),
                        torch.float32)
    native.check_tensor("ab", ab, dev, (NB * GROUP, PACK_LANES),
                        torch.float32)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    lx, ly, lz, l2 = (0.0,) * 4 if light is None else (float(x)
                                                       for x in light)
    wide = xla_rsqrt.device_table(dev, wide=True)
    native.TRACE_SHADE_PERLANE(
        state.data_ptr(), out.data_ptr(), R, plt_i.data_ptr(),
        plt_s.data_ptr(), ab.data_ptr(), P, NB, ray_chunk,
        chunk_live.data_ptr(), s0, s1, int(fixed_rng), float(weight_cutoff),
        int(light is not None), lx, ly, lz, l2,
        xla_rsqrt.device_table(dev).data_ptr(),
        0 if wide is None else wide.data_ptr(), native.stream(dev))
    return out
