"""Per-ray differential debug tracer (reference debug.rs:8-222).

The torch port's copy of `rust_raytrace_tpu/utils/raydebug.py`: numpy only,
so the port imports nothing of the JAX package; `from_render_result` reads
the port's `render.RenderResult`.

The reference's main correctness methodology: each backend records, per
primary ray (keyed by quantized origin), the candidate-triangle set, the
winning hit id and hit time; CSVs are dumped and `compare_to` diffs two
backends' traces, classifying each mismatch as a traversal bug ("their hit
not in our tri list") or an intersection bug ("bad hit detection") —
debug.rs:150-222.

The wavefront renderers return per-pixel primary hit-id/hit-t buffers
(RenderResult.primary_id/primary_t) natively, so this module adapts both
sources into the reference CSV format and reimplements the differ:

  - `DebugCtx`: incremental per-ray recording for the scalar oracle path
    (register_ray / add_ray / update_ray_triangles / update_ray_hit);
  - `from_render_result`: builds a DebugCtx from a wavefront render
    (candidate sets can be attached from the packet cull's page lists);
  - `write_debug_header` / `write_all_debug_context`: the reference CSV
    `Pixel_x;Pixel_y;ray_p;ray_v;tri_hit;hit_t;check_tris` (debug.rs:117-139);
  - `compare_to`: the classifying differ (debug.rs:150-222).
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, TextIO, Tuple

import numpy as np


@dataclass
class RayDebug:
    """One pixel's trace record (reference RayDebugCtx, debug.rs:8-15)."""

    orig: np.ndarray
    direction: np.ndarray
    pixel: Tuple[int, int]
    check_tris: list = field(default_factory=list)
    tri_hit: int = 0
    hit_t: float = 0.0

    def csv(self) -> str:
        tris = ",".join(str(int(t)) for t in self.check_tris)
        return (f"{self.pixel[0]};{self.pixel[1]};"
                f"{self.orig[0]},{self.orig[1]},{self.orig[2]};"
                f"{self.direction[0]},{self.direction[1]},{self.direction[2]};"
                f"{self.tri_hit};{self.hit_t};{tris}")


def _quantize_key(orig) -> Tuple[int, int, int]:
    """Primary-ray key: origin x1000 truncated to int (debug.rs:49-54)."""
    return (int(orig[0] * 1000.0), int(orig[1] * 1000.0),
            int(orig[2] * 1000.0))


class DebugCtx:
    """Reference DebugCtx (debug.rs:35-115)."""

    def __init__(self):
        self.checks: Dict[Tuple[int, int], RayDebug] = {}
        self.rays: Dict[Tuple[int, int, int], Tuple[int, int]] = {}

    def register_ray(self, orig, pixel: Tuple[int, int]):
        self.rays[_quantize_key(np.asarray(orig).reshape(-1))] = pixel

    def _pixel_for(self, orig) -> Optional[Tuple[int, int]]:
        return self.rays.get(_quantize_key(np.asarray(orig).reshape(-1)))

    def add_ray(self, orig, direction):
        px = self._pixel_for(orig)
        if px is not None:
            assert px not in self.checks
            self.checks[px] = RayDebug(
                orig=np.asarray(orig).reshape(-1).copy(),
                direction=np.asarray(direction).reshape(-1).copy(), pixel=px)

    def update_ray_triangles(self, orig, tri_indices):
        px = self._pixel_for(orig)
        if px is not None and px in self.checks:
            c = self.checks[px]
            c.check_tris = sorted(set(c.check_tris) | set(int(t) for t
                                                          in tri_indices))

    def update_ray_hit(self, orig, tri_hit: int, hit_t: float):
        px = self._pixel_for(orig)
        if px is not None and px in self.checks:
            self.checks[px].tri_hit = int(tri_hit)
            self.checks[px].hit_t = float(hit_t)

    # --- CSV dump (debug.rs:117-139) ---

    def write_debug_header(self, f: TextIO):
        f.write("Pixel_x;Pixel_y;ray_p;ray_v;tri_hit;hit_t;check_tris\n")

    def write_all_debug_context(self, f: TextIO):
        for px in sorted(self.checks):
            f.write(self.checks[px].csv() + "\n")

    # --- differ (debug.rs:141-222) ---

    @staticmethod
    def _rays_match(a: RayDebug, b: RayDebug, tol: float = 1e-4) -> bool:
        return (np.abs(a.orig - b.orig).max() < tol
                and np.abs(a.direction - b.direction).max() < tol)

    def compare_to(self, other: "DebugCtx", f: TextIO) -> int:
        """Write a classified diff report; returns the error count."""
        err = 0
        for px in sorted(self.checks):
            ours = self.checks[px]
            theirs = other.checks.get(px)
            if theirs is None:
                f.write(f"({px[0]},{px[1]}): No entry for pixel\n")
                err += 1
                continue
            if not self._rays_match(ours, theirs):
                f.write(f"({px[0]},{px[1]}): Ray Mismatch {ours.orig} vs "
                        f"{theirs.orig}\n")
                err += 1
                continue
            if ours.tri_hit != theirs.tri_hit:
                if ours.tri_hit == 0:
                    reason = ("Their hit not in our tri list"
                              if theirs.tri_hit in ours.check_tris
                              else "Bad hit detection for ray")
                else:
                    reason = ("Bad hit detection for ray"
                              if ours.tri_hit in theirs.check_tris
                              else "Their tri list does not contain our hit")
                f.write(f"({px[0]},{px[1]}): Hit Mismatch {ours.tri_hit} vs "
                        f"{theirs.tri_hit}. {reason}\n")
                err += 1
        f.write(f"Found {err} errors\n")
        return err


def from_render_result(result, viewport) -> DebugCtx:
    """Build a DebugCtx from a wavefront render's primary debug buffers.

    Requires the render to have been made with debug=True (engine) or any
    render.WavefrontRenderer render (buffers always present there).  When the
    result carries candidate buffers (engine debug renders: primary_chunk +
    chunk_tris, from the packet cull's surviving page lists), each pixel's
    check_tris is its chunk's triangle set — the wavefront analog of the
    reference's per-leaf recording (raytrace.rs:1018-1021,
    cuda_raytrace.rs:368-373), enabling the differ's
    traversal-vs-intersection classification in both directions.
    """
    from ..camera import pixel_rays

    ctx = DebugCtx()
    pid = result.primary_id
    pt = result.primary_t
    if pid is None:
        raise ValueError("render was made without debug buffers")
    if pid.ndim == 3:      # spp > 1: use sample 0
        pid = pid[..., 0]
        pt = pt[..., 0]
    pchunk = getattr(result, "primary_chunk", None)
    ctris = getattr(result, "chunk_tris", None)
    h, w = pid.shape
    for row in range(h):
        for col in range(w):
            o, d = pixel_rays(viewport, np.asarray(row), np.asarray(col))
            ctx.register_ray(o, (row, col))
            ctx.add_ray(o, d)
            if pchunk is not None and ctris is not None:
                ctx.update_ray_triangles(o, ctris[int(pchunk[row, col])])
            hit = int(pid[row, col])
            if hit != 0:
                t = float(pt[row, col])
                ctx.update_ray_hit(o, hit, t)
    return ctx
