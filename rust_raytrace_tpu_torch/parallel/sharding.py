"""Image-tile data parallelism over a list of devices.

Counterpart: `rust_raytrace_tpu/parallel/sharding.py` (`make_mesh`,
`trace_rays_sharded`, `engine_render_sharded`).  The reference
parallelizes over image rows with a work queue and N CPU threads
(raytrace.rs:1181-1191); rays are independent, so the JAX package shards
the tile-order ray batch over a 1-D device mesh, replicates the scene's
tables and runs the same wavefront program on every shard, summing the
per-wave ray counts.  Here a "mesh" is a list of torch devices, and one
controller drives every shard in turn: each shard's rays go to its device,
the Engine's tables are replicated there once (`Engine._replica`), and the
shard runs the Engine's own per-device program (`Engine._dispatch`: the
compacted or the legacy wave loop) under the key fold_in(key, shard index),
as the JAX package folds each device's mesh position into its key.  The
CUDA paths make no host sync inside a shard's program, so shards on
different cards overlap.  Under fixed_rng the key is inert and the
assembled image equals the unsharded render's bit for bit; under live RNG
each shard's scatter hash keys on its own compacted layout (ROADMAP C3),
as on the JAX mesh.

The render across processes (`torch.distributed`, the JAX package's
multi-host claim), one rank a shard of this very split, is
`parallel/distributed.py`.
"""

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from ..utils.rng import fold_in


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """A 1-D mesh of n devices, as a list of torch devices.

    devices: the devices to take them from, in turn (one device given n
    times makes n shards of it); default, every CUDA device, or the CPU
    where torch sees none.  n_devices defaults to the number of devices."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(count)]
                   if count else [torch.device("cpu")])
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = n_devices or len(devices)
    return [devices[i % len(devices)] for i in range(n)]


def on_device(dev: torch.device):
    """A context in which kernels launch on `dev` (its CUDA device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _gather(parts, dim: int, dev):
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def trace_rays_sharded(st, o, d, key, mesh, maxdepth: int,
                       backend: str = "portable", ray_chunk: int = 256,
                       fixed_rng: bool = False):
    """`render.trace_rays` sharded over image tiles.

    st: a `render.SceneTensors`, replicated to each shard's device; o, d:
    [R, 3] with R divisible by the mesh size; key: two uint32 key words,
    shard i tracing under fold_in(key, i).  Returns (colors [R, 3] and
    wave_rays [maxdepth], the sum over the shards) on mesh[0]."""
    from ..render import trace_rays

    n = len(mesh)
    R = o.shape[0]
    if R % n:
        raise ValueError(f"ray count {R} not divisible by mesh size {n}")
    Rs = R // n
    colors, waves = [], []
    for i, dev in enumerate(mesh):
        st_i = st if st.PK.device == dev else dataclasses.replace(
            st, **{f.name: getattr(st, f.name).to(dev)
                   for f in dataclasses.fields(st)
                   if isinstance(getattr(st, f.name), torch.Tensor)})
        sl = slice(i * Rs, (i + 1) * Rs)
        with on_device(dev):
            c, aux = trace_rays(st_i, o[sl].to(dev), d[sl].to(dev),
                                fold_in(key, i), maxdepth=maxdepth,
                                backend=backend, ray_chunk=ray_chunk,
                                fixed_rng=fixed_rng)
        colors.append(c)
        waves.append(aux["wave_rays"])
    home = mesh[0]
    return _gather(colors, 0, home), \
        torch.stack([w.to(home) for w in waves]).sum(dim=0)


def engine_render_sharded(engine, o, d, alive, key, mesh, maxdepth: int,
                          fixed_rng: bool = False, spp: int = 1, pk0=None,
                          quantize: bool = True, want_primary: bool = False):
    """The Engine's whole device render, sharded over image tiles.

    o, d: [3, R] tile-order rays (pinhole-folded when pk0 is given) and
    alive [R] bool, R divisible by the mesh size times the ray chunk, each
    shard a multiple of 128 lanes and of spp (a pixel's samples never
    straddle two shards).  Each shard runs `engine._dispatch` (the
    compacted or the legacy loop, lit when the scene is, with the box
    filter and device quantization where quantize) on its device.
    Returns (image [3, R] float32 or [3, R // spp] u8, wave counts
    [maxdepth] summed over the shards, primary [2, R] rows (t, id) or
    None), on mesh[0]."""
    n = len(mesh)
    R = o.shape[1]
    if R % (n * engine.ray_chunk) or (R // n) % 128 or (R // n) % spp:
        raise ValueError(f"{R} rays do not split into {n} shards of whole "
                         f"chunks, 128-lane groups and sample groups")
    Rs = R // n
    imgs, counts, prims = [], [], []
    for i, dev in enumerate(mesh):
        rep = engine._replica(dev)
        sl = slice(i * Rs, (i + 1) * Rs)
        with on_device(dev):
            img, wc, primary, _ = rep._dispatch(
                maxdepth, spp, o[:, sl].to(dev), d[:, sl].to(dev),
                alive[sl].to(dev), fold_in(key, i), fixed_rng, want_primary,
                quantize, None if pk0 is None else pk0.to(dev))
        imgs.append(img)
        counts.append(torch.stack(wc))
        prims.append(primary)
    home = mesh[0]
    primary = _gather(prims, 1, home) if want_primary else None
    return (_gather(imgs, 1, home),
            torch.stack([c.to(home) for c in counts]).sum(dim=0), primary)
