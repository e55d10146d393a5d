"""The whole-name guard against JAX and the JAX package, the harness's own
imports, and the runs that must print no result."""

import ast
import json
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT
from harness.common import forbidden_modules


def test_guard_compares_whole_top_level_names():
    loaded = ["gccnmf_torch", "gccnmf_torch.ops.nmf", "gccnmf_tpu.ops", "jax.numpy", "jaxlib",
              "jaxtyping", "flax.linen", "flaxx", "numpy"]
    assert forbidden_modules(loaded) == ["flax.linen", "gccnmf_tpu.ops", "jax.numpy", "jaxlib"]
    assert forbidden_modules(["gccnmf_torch", "gccnmf_t", "jax_utils"]) == []


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"jax", "jaxlib", "flax", "gccnmf_tpu"}, path


def test_a_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sep_b16_60s_i16",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_beside_no_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sep_b16_60s_i16",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert "correct" not in json.loads(line) if line.startswith("{") else True
