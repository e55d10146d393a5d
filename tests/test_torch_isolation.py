"""The port stands alone: no JAX and nothing of gccnmf_tpu, a CUDA default
that raises without a card, and kernel wrappers that take the plain version
only for CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gccnmf_torch.models.offline import GCCNMFEnhancer, GCCNMFSeparator, OfflineConfig
from gccnmf_torch.ops.frontend_cuda import (
    frontend_basis, stft_gcc_frontend_cuda, stft_gcc_frontend_plain,
)
from gccnmf_torch.ops.windows import hann_symmetric

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = sorted((ROOT / "gccnmf_torch").rglob("*.py"))
PORT_FILES = PORT_MODULES + [ROOT / name for name in ("chip_smoke.py", "chip_nmf_phases.py",
                                                      "chip_simt_rows.py")]
FORBIDDEN = ("jax", "jaxlib", "gccnmf_tpu")


def _run(code: str, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_pulls_in_no_jax():
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            for p in PORT_MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr + res.stdout


def test_app_modules_import_no_gui_or_audio_stack():
    """The realtime app, the native tier, the GUI, profiling, the plots and
    the evaluation modules import on a machine without tkinter, matplotlib
    or sounddevice: each is imported only where a window, a figure or a
    device stream is built."""
    code = (
        "import sys\n"
        "import gccnmf_torch.gui, gccnmf_torch.gui_model, gccnmf_torch.realtime\n"
        "import gccnmf_torch.native, gccnmf_torch.profiling, gccnmf_torch.cli\n"
        "import gccnmf_torch.viz, gccnmf_torch.metrics, gccnmf_torch.pesq_p862\n"
        "import gccnmf_torch.baselines.numpy_ref, gccnmf_torch.utils.stamp\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('tkinter', '_tkinter', 'matplotlib', 'sounddevice')]\n"
        "assert not bad, bad\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr + res.stdout


def test_every_module_of_the_jax_package_has_its_counterpart():
    """The import scans above cover the evaluation modules, and the port
    keeps a module of the JAX package's name for each one, except the two
    whose job it does elsewhere: ``ops/xprec.py`` (its policy is
    ``precision.py``'s TF32 switches) and ``pallas_common.py`` (TPU only;
    every kernel keeps its ``make_mm`` contract)."""
    port = {p.relative_to(ROOT / "gccnmf_torch").as_posix() for p in PORT_MODULES}
    for name in ("metrics.py", "pesq_p862.py", "baselines/numpy_ref.py", "utils/stamp.py",
                 "viz.py"):
        assert name in port
    jax_pkg = {p.relative_to(ROOT / "gccnmf_tpu").as_posix()
               for p in (ROOT / "gccnmf_tpu").rglob("*.py")}
    missing = sorted(jax_pkg - port - {"ops/xprec.py", "ops/pallas_common.py"})
    # the Pallas kernels' counterparts are the CUDA wrappers
    assert all(m.endswith("_pallas.py") for m in missing), missing


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


KERNEL_PATH = (sorted((ROOT / "gccnmf_torch" / "csrc").glob("*.cu*"))
               + sorted((ROOT / "gccnmf_torch" / "ops").glob("*_cuda.py")))


@pytest.mark.parametrize("path", KERNEL_PATH, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_library_fft_on_the_kernel_path(path):
    """The kernels and their wrappers compute no transform through a
    library: no cuFFT in ``csrc/``, and no ``torch.fft`` (attribute or
    import) in ``ops/*_cuda.py``. The float32 iDFT of the syntheses and the
    front-end's float32 rDFT are the hand-written FFT of ``csrc/fft.cuh``."""
    text = path.read_text()
    assert "cufft" not in text.lower(), f"{path} names cuFFT"
    if path.suffix != ".py":
        return
    for node in ast.walk(ast.parse(text, filename=str(path))):
        if isinstance(node, ast.Attribute) and node.attr == "fft":
            assert not (isinstance(node.value, ast.Name) and node.value.id == "torch"), \
                f"{path}:{node.lineno} calls torch.fft"
        elif isinstance(node, ast.Import):
            assert all(not a.name.startswith("torch.fft") for a in node.names), \
                f"{path}:{node.lineno} imports torch.fft"
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            assert not mod.startswith("torch.fft") and not (
                mod == "torch" and any(a.name == "fft" for a in node.names)), \
                f"{path}:{node.lineno} imports torch.fft"


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GCCNMFSeparator()
    with pytest.raises(RuntimeError, match="CUDA"):
        GCCNMFSeparator(OfflineConfig(), device="cuda")
    w = np.ones((513, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GCCNMFEnhancer(w)


def test_asking_for_kernels_on_cpu_raises():
    for field in ("nmf_backend", "synthesis_backend", "frontend_backend"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            GCCNMFSeparator(OfflineConfig(**{field: "cuda"}), device="cpu")
    for field in ("synthesis_backend", "frontend_backend"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            GCCNMFEnhancer(np.ones((513, 8), np.float32), OfflineConfig(**{field: "cuda"}),
                           device="cpu")


def test_wrapper_on_cpu_tensor_runs_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((1, 2, 64 + 16 * 5)) * 0.1).astype(np.float32))
    from gccnmf_torch.ops import gcc

    cos_m, sin_m = (torch.from_numpy(m) for m in gcc.steering_cos_sin(16000.0, 33, 1.0, 8))
    args = (x, frontend_basis(hann_symmetric(64)), cos_m, sin_m)
    before = stft_gcc_frontend_cuda.launches
    out = stft_gcc_frontend_cuda(*args, hop_size=16)
    assert stft_gcc_frontend_cuda.launches == before  # no kernel ran
    assert out[0].shape == (1, 2, 6, 33) and out[5].shape == (1, 6, 8)
    for got, want in zip(out, stft_gcc_frontend_plain(*args, hop_size=16)):
        assert torch.equal(got, want)


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, without a card and
    in a directory that holds nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        res = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        if torch.cuda.is_available() and cwd == ROOT:
            continue  # with a card the run in the repo is the real thing
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
