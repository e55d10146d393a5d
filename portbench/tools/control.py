"""Readings for the limits of ``correct``: the program's numbers over many
seeds (short runs of the cell's own entry at its own size) and the
control's (the reference one step down in precision, put in the program's
place) on the same seeds, in one process on the card.

    python3 portbench/tools/control.py --workload sep_b16_60s_i16 --seconds 4 \
        --seeds 11 22 33 [--control-only]

``--workload`` names a cell of the manifest, or ``<cell>:<config>:<traffic>``
a cell that the manifest does not hold yet, by its files.

One JSON line per seed and side on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

from harness import common, manifest  # noqa: E402


def show(side: str, seed: int, check: dict) -> None:
    """One line: the numbers compared, and the quantiles (0, 0.5, 0.9,
    0.99, 0.999, 1) of each error the check collected."""
    spread = {k: [common.quantile(v, q) for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)]
              for k, v in check.get("errors", {}).items() if v}
    print(json.dumps(dict(side=side, seed=seed, correct=check["correct"],
                          numbers=check["numbers"], errors=spread)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if ":" in args.workload:
        cell = manifest.cell_from_files(*args.workload.split(":"))
    else:
        cell = manifest.load_cell(args.workload, manifest.find_manifest(ROOT))
    drv = manifest.entry(cell.config["entry"])
    for seed in args.seeds:
        ticks = None
        if not args.control_only:
            t0 = time.perf_counter()
            rec = drv.run(cell, seed=seed, seconds=args.seconds, trace=False, device="cuda",
                          t0=t0, out_dir=common.run_dir(cell.name + ".control", seed, False))
            ticks = rec["attempted"] + cell.traffic.get("warmup_ticks", 0)
            show("program", seed, rec["check"])
            del rec
            torch.cuda.empty_cache()
        if cell.config["entry"] == "stream_server":
            interval = cell.config["block_size"] / cell.config["sample_rate"]
            ticks = ticks or cell.traffic["warmup_ticks"] + int(round(args.seconds / interval))
            show("control", seed, drv.control(cell, seed, torch.device("cuda"), ticks))
        else:
            show("control", seed, drv.control(cell, seed, torch.device("cuda")))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
