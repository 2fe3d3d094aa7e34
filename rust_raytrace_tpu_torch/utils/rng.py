"""Threefry-2x32 keys, bitwise equal to `jax.random` (threefry2x32 impl).

Counterpart: `jax.random.PRNGKey`, `jax.random.fold_in` and
`jax.random.key_data` as `rust_raytrace_tpu/engine.py:_render_device_compact`
uses them to seed each wave (`kw = fold_in(key, wave)`, then `key_data(kw)` as
two uint32 words).  JAX builds a key from a seed by splitting the integer into
(high, low) 32-bit words, and `fold_in(key, data)` hashes the counter pair
(0, data) under the key with 20-round Threefry-2x32 and keeps both output
words (Salmon et al., SC'11).  Neither step depends on
`jax_threefry_partitionable`, which only changes how bulk random bits are
laid out.  The shade kernels draw their scatter vectors from a counter hash
of these words (`ops/shade.scatter_rv`), not from `jax.random` bit streams;
the bulk draws, which `uniform` reproduces, are the shadow jitter
(`engine.shadow_rays_od`), the legacy loop's and the portable renderer's
scatter vectors (`engine.legacy_rv`, `render._random_unit_vec`) and the
portable renderer's spp jitter (`render.camera_rays`); the Engine's spp
jitter hashes absolute positions (`ops.camera.pos_uniform`).

Keys are host numpy `[2]` uint32 arrays: they seed kernels as two scalars and
never need the device.
"""

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0, x1) -> tuple:
    """Both output words of Threefry-2x32 for one counter pair: Python ints,
    or int64 tensors of 32-bit words (the same expressions, elementwise)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.key_data(jax.random.PRNGKey(seed))` with 64-bit types off
    (JAX's default): the seed is cut to its low 32 bits, so the high word is
    always 0."""
    return np.asarray([0, int(seed) & _MASK], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.key_data(jax.random.fold_in(key, data))`."""
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32))
    return np.asarray(threefry2x32(k0, k1, 0, int(data) & _MASK),
                      dtype=np.uint32)


def uniform(key: np.ndarray, shape: tuple, device) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` with
    `jax_threefry_partitionable` on: element i of the row-major flattening
    hashes the counter (0, i) and keeps the xor of both output words; its
    top 23 bits are the mantissa of a float in [1, 2), less 1.

    Plain torch glue on `device` (the JAX package computes it in XLA, outside
    any kernel): int64 tensors hold the 32-bit words."""
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32))
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError(f"uniform: {n} draws; counters past 32 bits "
                         f"need the high word")
    a, b = threefry2x32(k0, k1, 0, torch.arange(n, device=device))
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return (bits.view(torch.float32) - 1.0).reshape(shape)
