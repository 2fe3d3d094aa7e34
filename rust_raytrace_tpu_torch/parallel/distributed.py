"""Image-tile data parallelism across processes: one rank a shard.

Counterpart: `rust_raytrace_tpu/parallel/sharding.py` run with one JAX
controller a process (its multi-host claim: `jax.distributed` and the same
mesh spanning every process), the shard_map programs
`engine_render_sharded` and `trace_rays_sharded`.  Here each rank of the
caller's default `torch.distributed` process group (`torchrun`, or
`spawn` below) takes one shard.  Rank r of n prepares only its own shard's
rays (`camera_rays_tiled(q_base=)`, the stream positions shard r of
`Engine.render_sharded` holds), runs the Engine's per-device program
(`Engine._dispatch`) under fold_in(key, r), as shard r of
`parallel.sharding.engine_render_sharded` does, and then the ranks sum
their wave counts and gather the image on rank 0.  So every result is bit
for bit what `Engine.render_sharded(n_devices=n)` gives: under fixed_rng
that is render()'s image, under live RNG the JAX package's on an n-device
mesh.  Each rank has its own host thread for its rays and its launches.

Devices.  A rank renders on the device its Engine (or SceneTensors) lives
on.  `rank_device()` gives the usual one, cuda:(LOCAL_RANK % device count),
and raises where torch sees no card: a rank runs on the CPU only where the
caller asks for it.

Backends.  Under nccl the collectives' tensors go on the rank's card, and
two ranks on one card raise (NCCL refuses a duplicate GPU), and rank 0
un-tiles the gathered image on its card before the copy to the host.  Under
gloo they go on the CPU (rank 0 un-tiles the image on the host), and ranks
may share a card.  Any other backend raises.

Agreement.  Before any collective of a call, the ranks gather a fingerprint
of their Engine (its schedule, chunking, regime, options and a digest of
its page tables) and of the call's arguments, and every rank raises where
any field differs: an Engine that autotuned in an earlier render() on one
rank would otherwise render another image, and ranks that disagree on the
shapes of a collective would wait in it until the group's timeout.  Under
nccl this gather runs over a gloo group of the same ranks, made once, so
that it raises before NCCL makes its communicator.
"""

import dataclasses
import hashlib
import os
import shutil
import socket
import tempfile
import time
import weakref
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine import _assemble_host_image, device_quantizable, pick_tile
from ..ops.untile import untile_u8
from ..render import RenderResult, trace_rays
from ..utils.rng import fold_in, prng_key
from .sharding import on_device


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where the caller gives one (the tests
    pass "cpu"); else cuda:(LOCAL_RANK % device count), LOCAL_RANK as
    torchrun and `spawn` set it (the group's rank where it is unset).
    Raises where torch sees no CUDA device: no fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: torch sees no CUDA device; pass "
                           "device='cpu' to run a rank on the CPU")
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else _ranks(None).rank
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass
class _Ranks:
    rank: int
    size: int
    comm: torch.device      # where the collectives' tensors go
    check: object           # the agreement gather's group (None: default)
    card: Optional[tuple]   # (host, card) under nccl, else None


#: the gloo group beside each nccl default group, for the agreement gather
_GLOO_BESIDE: dict = {}


def _ranks(dev) -> _Ranks:
    """The default process group as this module uses it, for a rank that
    renders on `dev` (None: only rank and size are read)."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build of torch")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first "
                           "(torchrun gives its address), or use spawn()")
    rank, size = dist.get_rank(), dist.get_world_size()
    backend = str(dist.get_backend())
    if dev is None or backend == "gloo":
        return _Ranks(rank, size, torch.device("cpu"), None, None)
    if backend != "nccl":
        raise ValueError(f"backend {backend!r}: a distributed render takes "
                         f"gloo or nccl")
    if dev.type != "cuda":
        raise ValueError(f"nccl collectives need the rank's tensors on its "
                         f"card, and this rank renders on {dev}: use gloo "
                         f"for ranks on the CPU")
    world = dist.group.WORLD
    if world not in _GLOO_BESIDE:
        _GLOO_BESIDE.clear()
        _GLOO_BESIDE[world] = dist.new_group(backend="gloo")
    props = torch.cuda.get_device_properties(dev)
    card = (socket.gethostname(), str(getattr(props, "uuid", dev.index)))
    return _Ranks(rank, size, dev, _GLOO_BESIDE[world], card)


def differences(fingerprints: list) -> list:
    """The fields in which the ranks' fingerprints differ, each as
    "name (rank 0: value, rank 1: value, ...)"."""
    out = []
    for name in fingerprints[0]:
        values = [f.get(name) for f in fingerprints]
        if any(v != values[0] for v in values[1:]):
            out.append(f"{name} (" + ", ".join(
                f"rank {r}: {v!r}" for r, v in enumerate(values)) + ")")
    return out


def shared_cards(cards: list) -> list:
    """The ranks that share a card with a lower rank ((host, card) keys)."""
    first = {}
    return [r for r, c in enumerate(cards) if first.setdefault(c, r) != r]


def _agree(ranks: _Ranks, fields: dict, what: str) -> None:
    """Gather every rank's fields (and card) and raise on every rank where
    they differ, or where two nccl ranks share a card."""
    every = [None] * ranks.size
    dist.all_gather_object(every, (fields, ranks.card), group=ranks.check)
    diff = differences([f for f, _ in every])
    if diff:
        raise RuntimeError(f"{what}: the ranks differ in " + "; ".join(diff))
    if ranks.card is not None:
        dup = shared_cards([c for _, c in every])
        if dup:
            raise RuntimeError(
                f"{what}: ranks {dup} share a card with another rank, which "
                f"NCCL refuses: give each rank its own card, or use gloo")


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


#: each Engine's page-table digest (its tables never change)
_TABLE_DIGESTS = weakref.WeakKeyDictionary()


def engine_fingerprint(engine) -> dict:
    """What two ranks' Engines must share to render one image: the
    schedule, the chunking, the regime, the options that change bits and
    a digest of the page tables."""
    if engine not in _TABLE_DIGESTS:
        p = engine.pages
        _TABLE_DIGESTS[engine] = _digest(p.PK, p.aabb_lo, p.aabb_hi)
    return {"ncompact": engine.ncompact, "ray_chunk": engine.ray_chunk,
            "bounce_chunk": engine.bounce_chunk,
            "page_size": engine.page_size, "streamed": engine.streamed,
            "compact": engine.compact, "exact_cull": engine.exact_cull,
            "bank_major": engine.bank_major, "gate_frac": engine.gate_frac,
            "pinhole_origin": engine.pinhole_origin,
            "weight_cutoff": engine.weight_cutoff, "light": engine.light,
            "tables": _TABLE_DIGESTS[engine]}


def _view_fields(v) -> tuple:
    return (v.width, v.height, v.samples_per_pixel, v.maxdepth,
            _digest(*(np.asarray(a, np.float32)
                      for a in (v.orig, v.cam, v.vu, v.vv))))


def shard_rays(engine, v, key, rank: int, n: int):
    """Rank `rank`'s shard of `Engine.render_sharded`'s n-way split: (R, o,
    d, alive0, pk0), R the whole render's padded ray count (n times
    render()'s quantum), o and d [3, R // n] the tile-order rays at stream
    positions rank * R // n onwards, through the pinhole fold, alive0 [R //
    n] the lanes inside the image, on the Engine's device."""
    spp = v.samples_per_pixel
    R0 = v.height * v.width * spp
    quantum = n * engine._quantum(spp)
    R = -(-R0 // quantum) * quantum
    Rs = R // n
    o, d, alive0, pk0 = engine._camera_rays(v, pick_tile(v.width, v.height),
                                            Rs, key, q_base=rank * Rs)
    return R, o, d, alive0, pk0


def _gather_on_0(x: torch.Tensor, ranks: _Ranks):
    """Every rank's x [rows, n_r] (equal shapes) side by side on rank 0
    ([rows, sum n_r], where the collectives' tensors go: the card under
    nccl, the host under gloo); None on the other ranks."""
    x = x.contiguous().to(ranks.comm)
    parts = ([torch.empty_like(x) for _ in range(ranks.size)]
             if ranks.rank == 0 else None)
    dist.gather(x, parts, dst=0)
    return torch.cat(parts, dim=1) if ranks.rank == 0 else None


def engine_render_distributed(engine, v, key=None, fixed_rng: bool = False,
                              debug: bool = False,
                              quantize: bool = True) -> RenderResult:
    """`Engine.render_sharded` with one rank a shard: call it on every rank
    of the default process group with an Engine of the same scene and
    arguments (each rank's Engine on its own device, `rank_device()`).

    Rank r renders the tile-order rays r * R/n .. (r+1) * R/n - 1 through
    `engine._dispatch` (the compacted or the legacy loop, lit when the
    scene is, the box filter and device quantization where quantize) under
    fold_in(key, r).  Rank 0 returns the image (and with debug the primary
    t and id buffers), assembled as render() assembles it; every rank
    returns the wave counts summed over the ranks, and the other ranks an
    image of None.  No autotune, as render_sharded has none.  Raises on
    every rank where the ranks' Engines or arguments differ."""
    dev = engine.device
    ranks = _ranks(dev)
    key = prng_key(0) if key is None else np.asarray(key, np.uint32)
    t0 = time.perf_counter()
    _agree(ranks, {**engine_fingerprint(engine), "view": _view_fields(v),
                   "key": tuple(int(k) for k in key), "fixed_rng": fixed_rng,
                   "debug": debug, "quantize": quantize},
           "engine_render_distributed")
    spp = v.samples_per_pixel
    quant = quantize and device_quantizable(spp)
    with on_device(dev):
        _, o, d, alive0, pk0 = shard_rays(engine, v, key, ranks.rank,
                                          ranks.size)
        img, wc, primary, _ = engine._dispatch(
            v.maxdepth, spp, o, d, alive0, fold_in(key, ranks.rank),
            fixed_rng, debug, quant, pk0)
        counts = torch.stack(wc).to(torch.int64).to(ranks.comm)
        dist.all_reduce(counts)
        img = _gather_on_0(img, ranks)
        primary = _gather_on_0(primary, ranks) if debug else None
    wave_rays = counts.cpu().numpy()
    image = pt = pid = None
    if ranks.rank == 0:
        tile = pick_tile(v.width, v.height)
        if quant:
            # where the gather put it: on the card under nccl
            image = untile_u8(img, v.height, v.width, tile).cpu().numpy()
        else:
            image = _assemble_host_image(img.cpu().numpy(), v,
                                         engine._perm(v, tile), spp,
                                         want_u8=quantize)
        if debug:
            pt, pid, _, _ = engine._debug_buffers(
                v, engine._perm(v, tile), primary.cpu(), None,
                engine.ray_chunk)
    return RenderResult(image=image, rays_traced=int(wave_rays.sum()),
                        wave_rays=wave_rays, primary_t=pt, primary_id=pid,
                        seconds=time.perf_counter() - t0)


def trace_rays_distributed(st, o, d, key, maxdepth: int,
                           backend: str = "portable", ray_chunk: int = 256,
                           fixed_rng: bool = False):
    """`parallel.sharding.trace_rays_sharded` with one rank a shard: call it
    on every rank with the same st (a `render.SceneTensors` on the rank's
    device) and the same global rays o, d [R, 3], R divisible by the world
    size.  Rank r traces rows r * R/n .. (r+1) * R/n - 1 on st's device
    under fold_in(key, r).  Returns, on every rank and on st's device, the
    colors [R, 3] (all-gathered) and wave_rays [maxdepth] (summed over the
    ranks)."""
    dev = st.PK.device
    ranks = _ranks(dev)
    n, R = ranks.size, o.shape[0]
    if R % n:
        raise ValueError(f"ray count {R} not divisible by {n} ranks")
    key = np.asarray(key, np.uint32)
    _agree(ranks, {"rays": R, "maxdepth": maxdepth, "backend": backend,
                   "ray_chunk": ray_chunk, "fixed_rng": fixed_rng,
                   "key": tuple(int(k) for k in key),
                   "page_size": st.page_size,
                   "tables": _digest(st.PK.cpu().numpy())},
           "trace_rays_distributed")
    Rs = R // n
    sl = slice(ranks.rank * Rs, (ranks.rank + 1) * Rs)
    with on_device(dev):
        c, aux = trace_rays(st, o[sl].to(dev), d[sl].to(dev),
                            fold_in(key, ranks.rank), maxdepth=maxdepth,
                            backend=backend, ray_chunk=ray_chunk,
                            fixed_rng=fixed_rng)
        c = c.contiguous().to(ranks.comm)
        parts = [torch.empty_like(c) for _ in range(n)]
        dist.all_gather(parts, c)
        waves = aux["wave_rays"].to(torch.int64).to(ranks.comm)
        dist.all_reduce(waves)
    return torch.cat(parts).to(dev), waves.to(dev)


def _rank_main(rank: int, fn, nprocs: int, backend: str, init_method: str,
               timeout: float, args: tuple) -> None:
    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=nprocs,
                            timeout=timedelta(seconds=timeout))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 600.0) -> None:
    """Run fn(rank, *args) in nprocs new processes (the spawn start method)
    on this host and wait for them: rank r with the default process group
    initialized (backend, a `file://` rendezvous in a new temporary
    directory, world size nprocs, rank r, `timeout` for its collectives)
    and LOCAL_RANK, RANK and WORLD_SIZE set as torchrun sets them.  fn must
    be a module-level function (it is pickled).  A rank that raises fails
    the call (the others are terminated); past `timeout` seconds every
    rank is killed and TimeoutError raised."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="rt-rdzv-")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    deadline = time.monotonic() + timeout
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, backend, init_method, timeout, args),
        nprocs=nprocs, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"spawn: {nprocs} ranks of {fn.__name__} "
                                   f"did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
