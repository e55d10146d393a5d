"""Start a world of ranks and bring back rank 0's result.

JAX needs no launcher: one process drives every device of its host. Here
each device is one process, so the commands (``separate --time-shards N``,
``pretrain --data-shards N``) and the tests start their worlds through
:func:`run_world`:

- under torchrun (``WORLD_SIZE`` set), this process is already one rank of
  the world, and ``fn`` runs here;
- otherwise ``world`` ranks are spawned (``multiprocessing``'s spawn
  method), rank r on ``cuda:r`` over NCCL or on the CPU over gloo, joined
  through a ``file://`` store in a temporary directory, so worlds started
  side by side never race for a port.

``fn`` and its arguments are pickled by import path, so a rank function
lives in the package: a spawned rank imports ``gccnmf_torch``, never the
caller's module, and checks that neither JAX nor ``gccnmf_tpu`` came in.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from gccnmf_torch.device import resolve_device
from gccnmf_torch.parallel import mesh as mesh_lib

__all__ = ["run_world", "TIMEOUT_S"]

#: seconds a spawned world may run before it is killed
TIMEOUT_S = 1800.0
# seconds the other ranks get to report after one has failed
_GRACE_S = 2.0
_FORBIDDEN = ("jax", "jaxlib", "gccnmf_tpu")


def run_world(fn, world: int, device, *args, timeout_s: float = TIMEOUT_S):
    """Run ``fn(*args)`` on every rank of a world of ``world`` ranks on
    ``device`` (the card by default) and return rank 0's result (None on
    the other ranks of a torchrun world).

    A rank that raises, dies or outlives ``timeout_s`` fails the call: the
    other ranks are stopped and the error carries every rank's traceback.
    On CUDA the world must fit the cards (make_mesh's "exceeds" error
    otherwise); it never moves to the CPU."""
    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        rank = mesh_lib.init_distributed(device=dev, timeout_s=timeout_s)
        if dist.get_world_size() != world:
            raise ValueError(f"asked for a world of {world}; torchrun started "
                             f"{dist.get_world_size()}")
        result = fn(*args)
        return result if rank == 0 else None
    if dev.type == "cuda":
        mesh_lib.check_mesh(world, 1, torch.cuda.device_count())
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="gccnmf_world_")
    # each rank takes its share of the caller's CPU threads
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, dev.type, os.path.join(store_dir, "store"),
                               timeout_s, threads, results, fn, args))
             for rank in range(world)]
    try:
        for p in procs:
            p.start()
        reports = _collect(procs, results, timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    failed = {r: tb for r, (ok, tb) in sorted(reports.items()) if not ok}
    if failed:
        raise RuntimeError(f"{len(failed)} of {world} ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in failed.items()))
    return reports[0][1]


def _collect(procs, results, timeout_s: float) -> dict:
    """Each rank's ``(ok, result or traceback)``, waiting at most
    ``timeout_s``; a rank that died or never reported counts as failed.

    A rank puts its report on ``results`` and then exits, and its queue's
    feeder thread has written the report into the pipe before the exit. So
    a rank seen to have exited is counted as one that never reported only
    after the queue has been read dry: the report may have arrived between
    a ``get`` that timed out and the look at the exit code."""
    world = len(procs)
    reports: dict = {}
    deadline = time.monotonic() + timeout_s
    failed_at = None

    def take(item):
        nonlocal failed_at
        rank, ok, payload = item
        reports[rank] = (ok, payload)
        if not ok and failed_at is None:
            failed_at = time.monotonic()

    while len(reports) < world:
        now = time.monotonic()
        if failed_at is not None and now > failed_at + _GRACE_S:
            break
        if now > deadline:
            for r in range(world):
                reports.setdefault(r, (False, f"timed out after {timeout_s} s"))
            break
        try:
            take(results.get(timeout=0.2))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in reports and p.exitcode is not None]
            while dead:  # what reached the pipe before those exits
                try:
                    take(results.get(block=False))
                except queue.Empty:
                    break
            for r in dead:
                if r not in reports:
                    reports[r] = (False, f"exited with code {procs[r].exitcode} before reporting")
                    failed_at = failed_at or time.monotonic()
    for r in range(world):
        reports.setdefault(r, (False, "stopped after another rank failed"))
    return reports


def imported_forbidden() -> list[str]:
    """The modules of JAX or ``gccnmf_tpu`` this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN)


def _rank_main(rank, world, device_type, store_path, timeout_s, threads, results, fn, args):
    """One spawned rank: join the world, run ``fn``, report, leave."""
    try:
        bad = imported_forbidden()
        if bad:
            raise RuntimeError(f"a rank imported {bad}")
        torch.set_num_threads(threads)
        dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        mesh_lib.init_group(dev, timeout_s, init_method=f"file://{store_path}", rank=rank,
                            world_size=world)
        results.put((rank, True, fn(*args)))
    except (Exception, SystemExit):  # the parent raises it, with every rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
