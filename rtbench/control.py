"""The readings the check's limits are set from, on the card at a cell's
own size: the program's numbers on many seeds (its lower reading) and the
control's (its upper reading).

    python -m rtbench.control --workload <cell> --seeds 1,2,3 [--program] [--control]

For each seed the reference renders the cell's checked frames (`check`)
once; --program renders them through a fresh Engine (its planning frame,
then the checked frame under the planned schedule, as a run's set-up and
window do) and compares; --control renders them with the reference in the
program's place under `reference.arith.lowered()` (float32 without the
exactness rules: a multiply and add rounded twice, torch's rsqrt) and
compares.  One JSON line a seed and reading.  --program takes one-card
cells only (a render across processes is read by its own runs); the
control renders any cell's shards on one card.  The benchmark's runs do
not run this.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rtbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    import numpy as np
    import torch

    from . import bench, check, traffic

    cell = bench.load_cell(a.workload)
    tr = cell.traffic
    if int(tr["ranks"]) != 1 and a.program:
        print("rtbench.control: --program reads one-card cells only; a "
              "cell across processes is read by its own runs",
              file=sys.stderr)
        return 2
    device = "cuda:0"
    for seed in (int(s) for s in a.seeds.split(",")):
        j = traffic.check_index(seed)
        t = time.perf_counter()
        ref_plan, ref_checked = check.reference_frames(cell, seed, j, device)
        ref_s = time.perf_counter() - t
        readings = {}
        if a.program:
            from rust_raytrace_tpu_torch.engine import Engine

            scene, view = bench.recipe(cell.config["recipe"]).build(
                cell.config, int(tr["spp"]), bool(tr["lit"]))
            eng = Engine(scene, device=device)
            key = traffic.frame_key(seed, j)
            got = [eng.render(view, key=key) for _ in range(2)]
            readings["program"] = [check.differ(ref_checked, (
                got[1].image, np.asarray(got[1].wave_rays))),
                check.differ(ref_plan, (got[0].image,
                                         np.asarray(got[0].wave_rays)))]
            del eng, got
            torch.cuda.empty_cache()
        if a.control:
            low_plan, low_checked = check.reference_frames(
                cell, seed, j, device, lowered=True)
            readings["control"] = [check.differ(ref_checked, low_checked)]
            if ref_plan is not None:
                readings["control"].append(check.differ(ref_plan, low_plan))
        for who, got in readings.items():
            print(json.dumps({
                "workload": a.workload, "seed": seed, "j": j, "who": who,
                **{k: max(g[k] for g in got) for k in check.LIMITS},
                "reference_s": ref_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
