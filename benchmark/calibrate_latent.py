"""Readings that a `latent` cell's correctness limits are set from (on the
card).

    python3 benchmark/calibrate_latent.py --workload stylegan3-t-batch32 --seeds 1,2,3 --side program
    python3 benchmark/calibrate_latent.py --workload stylegan3-t-batch32 --seeds 101,102 --side control

For each seed, the units a run with that seed compares are computed at the
cell's own sizes, by the program (`program`, through `harness/latent.py`
as a run computes them) or by the control (`control`: the plain reference
computed one precision below the configuration's, `harness.compare.control`:
float8 products in the layers the program runs in bf16, TF32 elsewhere),
and compared with the plain reference.  Prints one JSON line per seed with
every compared number, then the largest program reading or the smallest
control reading of each.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def readings(cell, seed, side, device, overrides=None):
    import torch
    from harness import compare, latent
    from pix2pix3d_tpu_torch.ops import precision
    run = latent.LatentCell(cell, seed, device, overrides)
    with torch.no_grad(), precision.policy(run.traffic["tf32"]):
        if side == "program":
            for k in sorted(run.keep):
                run.keep_outputs(k, run.unit(k))
    run.free_program()
    program = None
    if side == "control":
        ctl = latent.reference_generator(run.gkw, seed, device)

        def program(z, c):
            with compare.control(ctl):
                return ctl(z, c, truncation_psi=run.psi)
    return run.check({}, program=program).values


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    args = p.parse_args(argv)
    import torch
    from harness import spec
    from harness.log import log
    if not torch.cuda.is_available():
        print("calibrate_latent: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    per_seed = []
    for seed in seeds:
        values = readings(cell, seed, args.side, device)
        per_seed.append(values)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "numbers": values}), flush=True)
        log(f"seed {seed} done")
    pick = max if args.side == "program" else min
    summary = {k: pick(v[k] for v in per_seed) for k in per_seed[0]}
    print(json.dumps({"workload": args.workload, "side": args.side, "seeds": seeds,
                      ("largest" if args.side == "program" else "smallest"): summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
