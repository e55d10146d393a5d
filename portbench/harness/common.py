"""Pieces the entries share: the module guard, quantiles, the run's own
directory, the sampler of the card's clocks and power, and pacing."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "gccnmf_tpu"})
OUT_DIR = Path(__file__).resolve().parent.parent / "out"
SMI_QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of :data:`FORBIDDEN_MODULES`: ``gccnmf_torch`` is not
    ``gccnmf_tpu``, though both begin with ``gccnmf_t``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES})


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    i = int(pos)
    if i + 1 >= len(xs):
        return float(xs[-1])
    return float(xs[i] + (xs[i + 1] - xs[i]) * (pos - i))


def run_dir(workload: str, seed: int, trace: bool) -> Path:
    """This run's own directory for its timings and trace (fixed by the
    workload, the seed and the mode)."""
    d = OUT_DIR / workload / f"seed{seed}-trace{int(trace)}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def write_json(path: Path, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)


class SmiSampler:
    """``nvidia-smi`` read every ``period_ms`` into ``path`` beside a
    window; a no-op where there is no ``nvidia-smi``."""

    def __init__(self, path: Path, period_ms: int = 500):
        self.path, self.period_ms, self._proc, self._fh = path, period_ms, None, None

    def __enter__(self):
        try:
            self._fh = open(self.path, "w")
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader",
                 f"-lms={self.period_ms}"], stdout=self._fh, stderr=subprocess.DEVNULL)
        except OSError:
            self._proc = None
        return self

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        if self._fh is not None:
            self._fh.close()
        return False


def pace_until(t: float) -> None:
    """Sleep, then spin, until ``time.perf_counter()`` reaches ``t``."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.0015)
