"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metric readers are found
by name (`harness/spec.py`).  With `--trace 0` the result's metrics are the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read
from a profiled stretch of units after the window.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, with `--trace 1` breakdown, and last `checks`, each compared number
beside its limit (also the last lines of standard error).  The run needs a
CUDA device and exits non-zero without one, printing no result.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
WALL_AT_START = time.time()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# caches of the program's builds and kernels stay inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(BENCH), str(ROOT)]

import argparse  # noqa: E402
import importlib  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pix2pix3d_tpu")


def process_start_wall():
    """The process's start on the wall clock (Linux), else this module's."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time() - (time.perf_counter() - T_START)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from harness import result, spec
    cell = spec.cell(args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    before_s = max(WALL_AT_START - process_start_wall(), 0.0)
    kind = importlib.import_module(f"harness.{cell['traffic']['kind']}")
    measured = kind.measure(cell, args.seed, args.seconds, bool(args.trace), device)
    setup_s = before_s + measured["window"].opened - T_START
    line = result.build(cell, measured, bool(args.trace), device, setup_s)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
