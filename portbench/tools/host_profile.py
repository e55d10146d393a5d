"""Where the host's time goes in an offline cell's window: ``cProfile``
over ``--chunks`` chunks of the pipelined entry after the cell's warm-up,
the heaviest functions by their own time on standard output.

    python3 portbench/tools/host_profile.py --workload sep_b16_60s_i16 --chunks 20
"""

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

from harness import manifest  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    from gccnmf_torch.models.offline import GCCNMFSeparator

    cell = manifest.load_cell(args.workload, manifest.find_manifest(ROOT))
    drv = manifest.entry(cell.config["entry"])
    sep = GCCNMFSeparator(drv.offline_config(cell.config), device="cuda")
    pool, _ = drv.make_pool(cell.config, cell.traffic, args.seed, sep.device)
    io_dtype = cell.config["io_dtype"]
    for _ in sep.separate_batches([pool[0]], io_dtype=io_dtype):
        pass

    def endless():
        i = 0
        while True:
            yield pool[i % len(pool)]
            i += 1

    gen = sep.separate_batches(endless(), io_dtype=io_dtype)
    for _ in range(3):
        next(gen)
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    for _ in range(args.chunks):
        next(gen)
    prof.disable()
    torch.cuda.synchronize()
    print(f"{args.chunks} chunks in {time.perf_counter() - t:.3f} s under cProfile")
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
    print(out.getvalue())
    gen.close()


if __name__ == "__main__":
    main()
