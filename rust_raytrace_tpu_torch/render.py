"""Render results.

Counterpart: `rust_raytrace_tpu/render.py:RenderResult` (copied: that module
imports jax).  The port's `Engine.render` fills `image`, `rays_traced`,
`wave_rays` and `seconds`; the debug buffers stay None until the port has
debug renders (ROADMAP A7).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] u8, or f32 with quantize=False
    rays_traced: int           # total project_ray-equivalent calls
    wave_rays: np.ndarray      # [maxdepth] per-wave live-ray counts
    primary_t: np.ndarray      # [H, W(,S)] primary hit times (debug buffer)
    primary_id: np.ndarray     # [H, W(,S)] primary hit ids (0 = miss)
    seconds: float = 0.0
    primary_chunk: np.ndarray = None   # [H, W] int or None
    chunk_tris: list = None            # [NC] arrays of tri ids or None

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-12) / 1e6
