"""The serving knee: paced windows of ``rt_default_serve`` at several
stream counts in one process on the card, each reporting its tick tail and
late share. The knee is the largest count (a multiple of 64) at which the
p99 stays within the 32 ms deadline and at most 1 % of ticks are late.

    python3 portbench/tools/knee_sweep.py --seconds 34 --streams 1024 2048 4096 [--bisect]

With ``--bisect`` the sweep then halves the gap between the last count
that passed and the first that failed down to 64 streams. One JSON line a
count on standard output.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

from harness import common, manifest  # noqa: E402


def window(drv, cfg, traffic, n, seconds, seed, torch):
    from gccnmf_torch.serving import StreamServer

    dev = torch.device("cuda")
    w, pool = drv.make_inputs(cfg, dict(traffic, streams=n), seed, dev)
    feed = drv.Feed(pool, n, cfg["block_size"], np.random.default_rng(seed))
    server = StreamServer(w, drv.stream_config(cfg), max_streams=n,
                          pipeline_depth=cfg["pipeline_depth"], wire_dtype=cfg["wire_dtype"],
                          device=dev)
    ids = [server.open_stream(drv.settings(cfg)) for _ in range(n)]
    for j in range(traffic["warmup_ticks"]):
        server.process(dict(zip(ids, feed.tick(j))))
    interval = cfg["block_size"] / cfg["sample_rate"]
    ticks = int(round(seconds / interval))
    lat, dur = drv.paced(server, ids, feed, traffic["warmup_ticks"], ticks, interval,
                         lambda res: None)
    server.close()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    ms = lambda q, v=lat: 1e3 * common.quantile(v, q)  # noqa: E731
    row = dict(streams=n, ticks=ticks, p50_ms=ms(0.5), p95_ms=ms(0.95), p99_ms=ms(0.99),
               max_ms=1e3 * float(lat.max()), late_pct=100.0 * float((lat > interval).mean()),
               process_mean_ms=1e3 * float(dur.mean()))
    row["passes"] = row["p99_ms"] <= 1e3 * interval and row["late_pct"] <= 1.0
    print(json.dumps(row), flush=True)
    return row["passes"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=34.0)
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args(argv)
    import torch

    cell = manifest.cell_from_files("serve_rt_p80", "rt_default_serve", "live_paced_p80")
    drv = manifest.entry(cell.config["entry"])
    results = {}
    for n in args.streams:
        results[n] = window(drv, cell.config, cell.traffic, n, args.seconds, args.seed, torch)
    if args.bisect:
        good = max((n for n, ok in results.items() if ok), default=None)
        bad = min((n for n, ok in results.items() if not ok and (good is None or n > good)),
                  default=None)
        while good is not None and bad is not None and bad - good > 64:
            mid = (good + bad) // 2 // 64 * 64
            if window(drv, cell.config, cell.traffic, mid, args.seconds, args.seed, torch):
                good = mid
            else:
                bad = mid
        print(json.dumps(dict(knee_streams=good, first_failing=bad)), flush=True)


if __name__ == "__main__":
    main()
