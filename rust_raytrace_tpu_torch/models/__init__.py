"""Scene model families (the reference's hard-coded scenes + BASELINE configs).

The torch port's copy of `rust_raytrace_tpu/models/__init__.py`: numpy only,
so the port imports nothing of the JAX package.

Each module exposes `build(...) -> (Scene, Viewport)`:

  - `teapot`:  the reference's only active scene (raytrace/src/main.rs:116-173)
               at its preset resolutions (64^2 dev, 640x480, 2k, 4k).
  - `circles`: procedural sphere-shell scene for the circles_2k config
               (geometry via `make_sphere`, raytrace.rs:464-529, which main.rs
               no longer calls — scene parameters are this repo's own).
  - `multi`:   multi-object instanced scene (teapots + spheres + disks,
               reflective, multi-bounce) for the BASELINE "multi-object" config.
  - `obj`:     any user .obj mesh with an auto-framed camera (the reference
               can only render assets compiled into main.rs) — CLI `--obj`.
  - `dog`:     dm_control's dog at qpos0 as MuJoCo draws it (49,548
               triangles), its floor, light and camera, from the file
               `scripts/bake_dog.py` bakes.
"""

from . import teapot, circles, multi, objfile, dog  # noqa: F401

REGISTRY = {
    "teapot": teapot.build,
    "circles": circles.build,
    "multi": multi.build,
    "obj": objfile.build,       # any user .obj via --obj PATH
    "dog": dog.build,
}
