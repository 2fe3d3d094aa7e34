"""Rank programs of tests/test_torch_distributed.py.

`parallel.distributed.spawn` starts each rank in a new process that
imports this module (never JAX or the JAX package), so the programs live
here and not in the test file.  Each writes what its rank returned to
OUT/rank<r>.pkl for the parent to compare."""

import os
import pickle

import torch

from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.parallel import distributed
from rust_raytrace_tpu_torch.render import upload_scene


def _write(out: str, rank: int, obj) -> None:
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def run_cases(rank: int, cases: dict, out: str) -> None:
    """Each case on this rank, in order: "render" cases through
    `engine_render_distributed` (an Engine of the case's scene on the CPU),
    "trace" cases through `trace_rays_distributed`."""
    torch.set_num_threads(1)
    results = {}
    for name, case in cases.items():
        if case["kind"] == "render":
            eng = Engine(case["scene"], device="cpu", **case["engine"])
            results[name] = distributed.engine_render_distributed(
                eng, case["view"], **case["render"])
        else:
            st = upload_scene(case["scene"], page_size=case["page_size"],
                              device="cpu")
            colors, waves = distributed.trace_rays_distributed(
                st, torch.from_numpy(case["o"]), torch.from_numpy(case["d"]),
                case["key"], **case["trace"])
            results[name] = (colors.numpy(), waves.numpy())
    _write(out, rank, results)


def mismatched(rank: int, scene, view, out: str) -> None:
    """Rank 0 compacts after waves 0 and 1, rank 1 never: the render must
    raise on both ranks.  Writes the message, or None where none raised."""
    torch.set_num_threads(1)
    eng = Engine(scene, ray_chunk=128, ncompact=2 if rank == 0 else 0,
                 device="cpu")
    try:
        distributed.engine_render_distributed(eng, view, fixed_rng=True)
    except RuntimeError as e:
        _write(out, rank, str(e))
    else:
        _write(out, rank, None)
