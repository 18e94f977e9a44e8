"""Readings that a training cell's correctness limits are set from (on the
card).

    python3 benchmark/calibrate_train.py --workload seg2cat-train --seeds 1,2,3 [--control 1,2] [--repeat 3]

For each seed, the program steps through the cell's path (`harness/train.py`)
up to its last compared step, untimed, and its compared steps are compared
with the plain reference; for the seeds in `--control`, so is the control
(the reference one precision below the configuration's: float8 products in
the blocks the program runs in bf16, TF32 elsewhere), and for those in
`--repeat` the reference computed again (its own run-to-run spread).  Each
line also gives each loss stat's largest relative error (`stat:<name>`).  Prints one JSON line
per seed and side with every compared number, then the largest program
reading and the smallest control reading of each.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def readings(cell, seed, sides, device, overrides=None):
    from harness import train
    from pix2pix3d_tpu_torch.ops import precision
    run = train.TrainCell(cell, seed, device, overrides)
    try:
        with precision.policy(cell["traffic"]["tf32"]):
            while run.step_idx <= max(run.compared):
                run.step()
            run.free_program()
            return {side: dict(w.values, **{f"stat:{k}": v for k, v in w.stat_errors.items()})
                    for side, w in run.compare({}, sides).items()}
    finally:
        run.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="", help="seeds that also read the control")
    p.add_argument("--repeat", default="", help="seeds that also read the reference again")
    args = p.parse_args(argv)
    import torch
    from harness import spec
    from harness.log import log
    if not torch.cuda.is_available():
        print("calibrate_train: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    control = {int(s) for s in args.control.split(",") if s}
    repeat = {int(s) for s in args.repeat.split(",") if s}
    seen = {"program": [], "control": [], "repeat": []}
    for seed in [int(s) for s in args.seeds.split(",")]:
        sides = (("program",) + (("control",) if seed in control else ())
                 + (("repeat",) if seed in repeat else ()))
        for side, values in readings(cell, seed, sides, device).items():
            seen[side].append(values)
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                              "numbers": values}), flush=True)
        log(f"seed {seed} done")
    for side, pick, word in (("program", max, "largest"), ("control", min, "smallest"),
                             ("repeat", max, "largest")):
        if seen[side]:
            summary = {k: pick(v[k] for v in seen[side]) for k in seen[side][0]}
            print(json.dumps({"workload": args.workload, "side": side, word: summary}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
