"""Depth-indented debug tracing (the reference's RUST_LOG=debug analog).

The torch port's copy of `rust_raytrace_tpu/utils/tracelog.py`, on its own
logger, "rust_raytrace_tpu_torch.trace".

The reference traces every projected ray and every octree-node visit through
`log::debug!` with depth indentation (raytrace.rs:912-918, 954-958, 1027,
1259), enabled at runtime by the RUST_LOG env var (env_logger init at
main.rs:91).  The analog here is the stdlib logging module on the
"rust_raytrace_tpu_torch.trace" logger, enabled by

    RUST_RAYTRACE_LOG=debug python -m rust_raytrace_tpu_torch.cli render ...

or programmatically via logging.getLogger("rust_raytrace_tpu_torch.trace").
Tracing hooks live on the RECURSIVE ORACLE and the octree walk — the scalar
paths whose control flow mirrors the reference's (the batched device paths
have no per-ray control flow to narrate; their story is the ray differ).
"""

import logging
import os

logger = logging.getLogger("rust_raytrace_tpu_torch.trace")

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}


def init_from_env():
    """env_logger::init() analog (main.rs:91): RUST_RAYTRACE_LOG=debug."""
    level = os.environ.get("RUST_RAYTRACE_LOG", "").lower()
    if level in _LEVELS:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(levelname)s %(name)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(_LEVELS[level])


def enabled() -> bool:
    return logger.isEnabledFor(logging.DEBUG)


def ray(r_orig, r_dir):
    """project_ray entry (raytrace.rs:1259)."""
    if enabled():
        logger.debug("Ray: orig=%s dir=%s", list(map(float, r_orig)),
                     list(map(float, r_dir)))


def box_visit(depth: int, desc: str):
    """octree node entry (raytrace.rs:912)."""
    if enabled():
        logger.debug("%sBounding box: %s", " " * depth, desc)


def box_kind(depth: int, kind: str):
    """'Subobjects' / 'Subboxes' (raytrace.rs:915, 928)."""
    if enabled():
        logger.debug("%s %s", " " * depth, kind)


def tri_hit(depth: int, tnum: int, t: float):
    """per-triangle hit inside a leaf (raytrace.rs:1027)."""
    if enabled():
        logger.debug("%s  Hit %d at %s", " " * depth, tnum, t)


def leaf_result(depth: int, result):
    """leaf min-hit summary (raytrace.rs:916-923)."""
    if enabled():
        if result is None:
            logger.debug("%s No hits", " " * depth)
        else:
            logger.debug("%s Min hit at %s with %d", " " * depth,
                         result[0], result[3])
