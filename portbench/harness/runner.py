"""One run of one cell: its entry, the metric readers, the module guard
and the result line."""

from __future__ import annotations

import json
import math
import sys

from harness import common, manifest


class ForbiddenModules(RuntimeError):
    pass


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, bench_dir=manifest.BENCH_DIR) -> dict:
    """Run ``cell`` once and return the result line's object. Raises
    :class:`ForbiddenModules` when the process holds a forbidden module
    once the window has closed."""
    import torch

    out_dir = common.run_dir(cell.name, seed, trace)
    drv = manifest.entry(cell.config["entry"], bench_dir)
    rec = drv.run(cell, seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
                  out_dir=out_dir)
    bad = common.forbidden_modules()
    if bad:
        raise ForbiddenModules(", ".join(bad))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m.kind != kind:
            continue
        value = manifest.metric_reader(m.name, bench_dir).read(rec)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    check = rec["check"]
    dev = torch.device(device)
    if dev.type == "cuda":
        count = max(1, cell.chips)
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=count,
                    memory_peak_bytes=rec.get("memory_peak_bytes", 0))
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    line = dict(correct=bool(check["correct"]), attempted=int(rec["attempted"]),
                failed=int(check["failed"]), metrics=metrics, device=info)
    tr = rec.get("trace")
    if trace and tr:
        info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = dict(device_ops=tr["device_ops"], idle_gaps=tr["idle_gaps"])
    # the numbers compared, each beside its limit, last in the line
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in check["numbers"].items()}
    common.write_json(out_dir / "result.json", line)
    common.write_json(out_dir / "check.json", check.get("errors", {}))
    return line


def print_result(line: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in line["compared"].items():
        v = c["value"]
        shown = v if isinstance(v, int) or not math.isfinite(v) else f"{v:.6g}"
        print(f"compared {k} = {shown} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
