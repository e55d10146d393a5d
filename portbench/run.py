"""Run one cell of the benchmark of ``gccnmf_torch`` and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the port.
The run makes its inputs from the seed, warms the cell's shapes (set-up),
measures for ``--seconds``, checks the outputs of the timed path against
the plain reference, and prints one JSON line as the last line of standard
output: the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``. It exits non-zero and prints no result when the cell's
cards are missing, when a run fails, or when JAX or the JAX package was
loaded. The program builds its kernels into ``gccnmf_torch/build/`` inside
the checkout (a fixed path), so only a checkout's first run compiles.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest, runner  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload, manifest.find_manifest(ROOT))
    import torch

    import gccnmf_torch  # noqa: F401  the program under test, from this checkout

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    try:
        line = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except runner.ForbiddenModules as e:
        print(f"forbidden modules loaded: {e}", file=sys.stderr)
        return 3
    runner.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
