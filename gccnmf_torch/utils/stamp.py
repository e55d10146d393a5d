"""Provenance stamp for benchmark artifacts (counterpart of
``gccnmf_tpu/utils/stamp.py``).

A JSON artifact embeds ``run_stamp()`` under a ``"stamp"`` key, so a number
can be traced from the artifact alone to the commit that produced it, the
torch and CUDA versions it ran with, the time and the configuration.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import time

__all__ = ["git_sha", "config_fingerprint", "run_stamp"]


def git_sha(repo_dir: str | None = None) -> str | None:
    """Short git SHA of the checkout holding this file (or ``repo_dir``),
    with a ``-dirty`` suffix when tracked files are modified; ``None``
    outside a git checkout or without git."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=repo_dir,
                             capture_output=True, text=True, timeout=10).stdout.strip()
        if not sha:
            return None
        dirty = subprocess.run(["git", "status", "--porcelain", "--untracked-files=no"],
                               cwd=repo_dir, capture_output=True, text=True, timeout=10)
        return sha + "-dirty" if dirty.stdout.strip() else sha
    except (OSError, subprocess.SubprocessError):
        return None


def config_fingerprint(cfg) -> str:
    """Stable 12-hex fingerprint of a config dataclass or dict: which
    configuration produced a number."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        d = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        d = cfg
    else:
        d = {"repr": repr(cfg)}
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def run_stamp(config_fingerprint: str | None = None) -> dict:
    """Provenance dict: git SHA, UTC time, ``torch.__version__`` and
    ``torch.version.cuda`` (the toolkit torch was built with, ``None`` for
    a CPU build), and the producing config's fingerprint when given. The
    device is not queried: no CUDA context is created. Never raises."""
    stamp: dict = {
        "git_sha": git_sha(),
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    try:
        import torch

        stamp["torch_version"] = torch.__version__
        stamp["torch_cuda"] = torch.version.cuda
    except ImportError:
        pass
    if config_fingerprint is not None:
        stamp["config_fingerprint"] = config_fingerprint
    return stamp
