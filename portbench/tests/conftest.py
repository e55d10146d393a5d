"""Import paths and small cells for the benchmark's own tests (run from the
root of the repository: ``python -m pytest portbench/tests``)."""

import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# traffic cut to what a CPU test holds; sizes that set the work (window,
# atoms, iterations, TDOAs) stay as configured
SMALL = {
    "offline_separate_batches": dict(batch=2, seconds_per_mixture=1.5, pool=2, check_pools=2,
                                     trace_chunks=1),
    "stream_server": dict(streams=4, pool=2, pool_blocks=40, check_streams=3, warmup_ticks=4,
                          trace_ticks=2),
}


# the serving configuration and traffic, which no cell of the manifest runs yet
SERVE = ("serve_rt_p80", "rt_default_serve", "live_paced_p80")


@pytest.fixture
def small_cell():
    """A cell of the manifest by name, or the serving pair ``SERVE`` (from
    its files), with its traffic cut to CPU size."""
    from harness import manifest

    def make(workload):
        if workload == SERVE:
            cell = manifest.cell_from_files(*SERVE)
        else:
            cell = manifest.load_cell(workload, manifest.find_manifest(ROOT))
        traffic = dict(cell.traffic, **SMALL[cell.config["entry"]])
        return dataclasses.replace(cell, traffic=traffic)

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
