"""The inputs of B13's branch cases: tests/test_torch_cull_sorted.py
(against the JAX package on the CPU) and tests/test_torch_cuda.py (the
kernel against its plain version on the card), built with numpy alone.

B13's kernel ranks a chunk's pages by the fast path (the hit pages among
themselves, every missed page after them in page order) where every hit
key is below BIGT, and by the all-pairs (key, page) rank otherwise.  A
hit key is the least max(tlo, 0) over the chunk's rays with a missing
ray's BIGT in the min, so it reaches BIGT only where rays hit a page at
an entry of BIGT or more: rays with zero direction components, whose slab
reciprocal is 1e30, and a far page.  No key is NaN: a hit needs tlo <=
thi, which a NaN fails."""

import numpy as np

F32 = np.float32
RB = 1024
NC = 4
#: chunk 0 takes the fast path; chunk 1 the all-pairs rank (a hit key
#: equal to BIGT and one beyond it); chunk 2 is flagged dead; chunk 3
#: holds no valid ray
FAST_CHUNK, ALL_PAIRS_CHUNK, DEAD_CHUNK, EMPTY_CHUNK = 0, 1, 2, 3
#: the far pages: A, which half of chunk 1's rays hit beyond BIGT and half
#: miss (key BIGT), and B, which all of them hit beyond it (key 3.2e38);
#: and C, whose x = 0 plane holds their origins (key 0)
PAGE_A, PAGE_B, PAGE_C = 37, 38, 39
NP = 40


def case(seed=5):
    """(o [3, R], d [3, R], valid [R] bool, blo [NP, 3], bhi [NP, 3],
    chunk_live [NC] int32) as numpy, R = NC * RB."""
    rng = np.random.default_rng(seed)
    R = NC * RB
    o = rng.uniform(-1.0, 1.0, (3, R)).astype(F32)
    d = rng.normal(size=(3, R)).astype(F32)
    d[0, :64] = 0.0                          # chunk 0: zero components
    valid = rng.uniform(size=R) > 0.2
    c = rng.uniform(-24.0, 24.0, (NP, 3)).astype(F32)
    h = rng.uniform(0.2, 1.0, (NP, 3)).astype(F32)
    blo, bhi = c - h, c + h
    # chunk 1: every ray valid, d = (0, 0, 1), half from the origin and
    # half from y = 2e9, outside page A's y slab
    s = slice(RB, 2 * RB)
    o[:, s] = 0.0
    o[1, RB + RB // 2:2 * RB] = 2e9
    d[:, s] = np.asarray([[0.0], [0.0], [1.0]], F32)
    valid[s] = True
    # x: entry 3.2e8 * 1e30 = 3.2e38 > BIGT; y: zero direction, a slab
    # wide enough to reach past it; z: up to 3.35e38
    blo[PAGE_A] = (3.2e8, -1e9, -1.0)
    bhi[PAGE_A] = (3.3e8, 1e9, 3.35e38)
    blo[PAGE_B] = (3.2e8, -1e10, -1.0)
    bhi[PAGE_B] = (3.3e8, 1e10, 3.35e38)
    blo[PAGE_C] = (0.0, -1.0, -1.0)
    bhi[PAGE_C] = (1.0, 1.0, 6.0)
    valid[3 * RB:] = False
    live = np.ones(NC, np.int32)
    live[DEAD_CHUNK] = 0
    return o, d, valid, blo, bhi, live


def fast_rank(mask, key):
    """The fast path's plist of one chunk: hit pages (mask) by (key, page),
    then the missed pages (and the padding past len(key)) in page order."""
    hits = np.nonzero(mask)[0]
    order = hits[np.lexsort((hits, key[hits]))]
    return np.concatenate([order, np.nonzero(~mask)[0]])
