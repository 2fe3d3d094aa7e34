"""Numpy model of the intersect kernel contract — the kernel's test oracle.

The torch port's copy of `rust_raytrace_tpu/ops/intersect_ref.py`, byte for
byte in its arithmetic: numpy only, with the lane constants and
`PageTables` of the port's own `ops/pages.py`.  No render path calls it.
In the port, B11 (`ops.intersect.nearest_hit`) keeps the least t and then
the least id, the "lex" rule below; `nearest_hit_xla` keeps the earlier
page on a cross-page tie, the "page" rule.

Plays the role of the reference's `exec_rust_raytrace`
(cuda_raytrace_lib/src/cuda_raytrace.rs:118-229): a slow, pure-host
implementation with EXACTLY the kernel's input/output contract, run in tests
(and optionally alongside the device kernel) to diff results per ray.  The
formulas mirror ops/pages.py exactly — same operand order, same prescaled
sides, no bounding-circle test — so kernel-vs-model comparisons are tight;
semantic comparisons against the geometric definition live in
oracle.intersect_all.

Contract (shared by intersect_xla and the nearest-hit kernels):
  inputs:  O, D            [R, 3] f32 ray origins / unit directions
           pages           PageTables (packed layout, ops/pages.py)
  outputs: best_t  [R] f32 — +inf where no hit
           best_id [R] int32 — triangle id, 0 = miss (sentinel convention of
                                cuda_rt.cu:317)
Tie-break: strictly-smaller t wins across pages (earlier page kept on equal t);
within a page, the smallest id among equal-t hits.
"""

import numpy as np

from .pages import (LANE_ID, LANE_N, LANE_NC, LANE_S0, LANE_S0C, LANE_S1,
                    LANE_S1C, LANE_S2, LANE_S2C, PageTables)

F32 = np.float32


def _page_hits(pk: np.ndarray, O: np.ndarray, D: np.ndarray):
    """tt [P, R] (+inf invalid) and ids [P] for one packed page."""
    def col(lane, width=3):
        return pk[:, lane:lane + width]          # [P, width]

    def dotray(lane, V):                          # [P, R]
        return col(lane) @ V.T

    with np.errstate(divide="ignore", invalid="ignore"):
        t = (pk[:, LANE_NC:LANE_NC + 1] - dotray(LANE_N, O)) / dotray(LANE_N, D)
        d0 = dotray(LANE_S0, O) + t * dotray(LANE_S0, D) - pk[:, LANE_S0C:LANE_S0C + 1]
        d1 = dotray(LANE_S1, O) + t * dotray(LANE_S1, D) - pk[:, LANE_S1C:LANE_S1C + 1]
        d2 = dotray(LANE_S2, O) + t * dotray(LANE_S2, D) - pk[:, LANE_S2C:LANE_S2C + 1]

    valid = (t >= 0) & (d0 <= 1) & (d1 <= 1) & (d2 <= 1)
    return np.where(valid, t, np.inf).astype(F32), pk[:, LANE_ID]


def nearest_hit_model(O: np.ndarray, D: np.ndarray, pages: PageTables,
                      page_order=None, tie: str = "page"):
    """page_order: optional per-ray-irrelevant page visit order (defaults to
    0..NP-1; the culled engine visits a subset — min is order-independent
    except for exact-tie id selection across pages).

    tie: cross-page rule for exactly-equal best t —
      "page": earlier-visited page wins (the union/chunk kernels' rule);
      "lex":  globally smallest id wins, independent of visit order (the
              per-lane kernel's rule, intersect_perlane.py body()).
    """
    O = np.asarray(O, dtype=F32)
    D = np.asarray(D, dtype=F32)
    R = O.shape[0]

    best_t = np.full(R, np.inf, dtype=F32)
    best_id = np.zeros(R, dtype=np.int32)

    for p in (page_order if page_order is not None else range(pages.num_pages)):
        tt, ids = _page_hits(pages.PK[p], O, D)
        page_min = tt.min(axis=0)                                 # [R]
        sel = np.where(tt == page_min[None, :], ids[:, None],
                       np.inf).min(axis=0)                        # low id on tie
        upd = page_min < best_t
        if tie == "lex":
            upd = upd | ((page_min == best_t) & np.isfinite(page_min)
                         & (sel < best_id))
        best_t = np.where(upd, page_min, best_t)
        best_id = np.where(upd, sel.astype(np.int32), best_id)

    return best_t, best_id
