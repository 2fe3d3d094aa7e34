"""Surface/material model as SoA parameter tables.

The benchmark reference's frozen copy of the port's `materials.py` (numpy
only): the reference imports nothing of the program.

The reference stores a per-triangle `SurfaceKind` enum — Solid / Matte /
Reflective (`raytrace_lib/src/raytrace.rs:303-308`).  On TPU, per-primitive
sum types become an integer kind array plus dense parameter tables gathered by
hit index; the wavefront shader selects behavior with `jnp.where` masks rather
than enum dispatch.

Kind encoding (stable ABI; also used by the native C++ scene pipeline):
  0 = Solid      {color}
  1 = Matte      {color, alpha}
  2 = Reflective {color, alpha, scattering}

Edge-wireframe shading (CollisionFace::EdgeFront/EdgeBack -> solid black,
raytrace.rs:450-460) is not a material here: it is a per-hit flag computed from
the winning triangle's edge band and applied in the shader.
"""

from dataclasses import dataclass

import numpy as np

F32 = np.float32

KIND_SOLID = 0
KIND_MATTE = 1
KIND_REFLECTIVE = 2


@dataclass(frozen=True)
class Surface:
    """One surface description (analog of a `SurfaceKind` value)."""

    kind: int
    color: np.ndarray          # [3] f32 in [0,1]
    alpha: float = 0.0         # bounce mix weight (Matte/Reflective)
    scattering: float = 0.0    # reflection fuzz (Reflective)


def solid(color) -> Surface:
    return Surface(KIND_SOLID, np.asarray(color, dtype=F32))


def matte(color, alpha) -> Surface:
    return Surface(KIND_MATTE, np.asarray(color, dtype=F32), alpha=float(alpha))


def reflective(color, alpha, scattering) -> Surface:
    return Surface(KIND_REFLECTIVE, np.asarray(color, dtype=F32),
                   alpha=float(alpha), scattering=float(scattering))


@dataclass
class MaterialTable:
    """Per-triangle material SoA (gathered by hit id in the shader)."""

    kind: np.ndarray        # [N] int32
    color: np.ndarray       # [N,3] f32
    alpha: np.ndarray       # [N] f32
    scattering: np.ndarray  # [N] f32

    @staticmethod
    def empty(n: int) -> "MaterialTable":
        return MaterialTable(
            kind=np.zeros(n, dtype=np.int32),
            color=np.zeros((n, 3), dtype=F32),
            alpha=np.zeros(n, dtype=F32),
            scattering=np.zeros(n, dtype=F32),
        )

    @staticmethod
    def broadcast(surface: Surface, n: int) -> "MaterialTable":
        return MaterialTable(
            kind=np.full(n, surface.kind, dtype=np.int32),
            color=np.broadcast_to(surface.color.astype(F32), (n, 3)).copy(),
            alpha=np.full(n, surface.alpha, dtype=F32),
            scattering=np.full(n, surface.scattering, dtype=F32),
        )

    @staticmethod
    def concat(tables) -> "MaterialTable":
        return MaterialTable(
            kind=np.concatenate([t.kind for t in tables]),
            color=np.concatenate([t.color for t in tables]),
            alpha=np.concatenate([t.alpha for t in tables]),
            scattering=np.concatenate([t.scattering for t in tables]),
        )

    def __len__(self) -> int:
        return self.kind.shape[0]
