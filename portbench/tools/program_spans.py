"""A cell's traced run with the program's own spans read: the cell's entry
as the benchmark runs it (``--trace 1``), with ``harness.trace.reduce``
extended to keep ``harness.program_trace.reduce`` of the same trace before
the entry deletes it, then the ``offline.*`` program readers of
``metrics/`` on that record.

    python3 portbench/tools/program_spans.py --workload sep_b16_60s_i16 --seed 7 --seconds 5

Prints three JSON lines: the run's result line, the program readers'
values with the traced window's seconds a chunk, and the reduction
(``program.json`` beside the run's files).
"""

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

from harness import common, manifest, program_trace, runner, trace as tracing  # noqa: E402

READERS = ("offline.idle_unattributed_pct", "offline.materialize_ms_per_chunk",
           "offline.enqueue_ms_per_chunk", "offline.kernel_launches_per_chunk")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload, manifest.find_manifest(ROOT))
    rate = next(m.name for m in cell.metrics if m.name.startswith("audio_s_per_s."))
    suffix = rate.split(".", 1)[1]

    kept = {}
    reduce = tracing.reduce

    def with_program(path, span_names=()):
        kept["trace"] = red = reduce(path, span_names)
        red["program"] = program_trace.reduce(path)
        return red

    tracing.reduce = with_program
    try:
        line = runner.run_cell(cell, args.seed, args.seconds, True, "cuda", T0)
    finally:
        tracing.reduce = reduce
    tr = kept["trace"]
    rec = {"trace": tr}
    values = {f"{r}.{suffix}": manifest.metric_reader(f"{r}.{suffix}").read(rec)
              for r in READERS}
    values["window_s_per_chunk"] = tr["window_s"] / tr["steps"]
    common.write_json(common.run_dir(cell.name, args.seed, True) / "program.json",
                      tr["program"])
    print(json.dumps(line))
    print(json.dumps(values))
    print(json.dumps(tr["program"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
