"""The port's separation CLI (``python -m gccnmf_torch.cli``) on the CPU,
after tests/test_cli_pretrain.py's CLI cases, against the JAX CLI where both
run the same path. The WAV is written from the seeded test mixture."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_torch import cli
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--dictionary-size", "16", "--num-iterations", "5"]


@pytest.fixture()
def wav_file(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "case_mix.wav")
    wav.write_wav(mix, path, sr)
    return path, sr


def _run(capsys, argv):
    assert cli.separate_main(argv) == 0
    return json.loads(capsys.readouterr().out.strip())


def test_rejects_mono_input_clearly(tmp_path):
    mono = str(tmp_path / "mono_mix.wav")
    wav.write_wav(np.zeros((1, 8192), np.float32) + 0.01, mono, 16000)
    with pytest.raises(SystemExit, match="stereo"):
        cli.separate_main([mono, *SMALL, "--num-sources", "1"])


def test_one_file_matches_jax_cli(wav_file, tmp_path, capsys):
    path, sr = wav_file
    info = _run(capsys, [path, "-o", str(tmp_path / "out"), "--num-sources", "2", *SMALL])
    assert set(info) == {"outputs", "target_tdoa_indexes"}  # the flat shape
    assert info["outputs"] == [str(tmp_path / f"out_sim_{i}.wav") for i in (1, 2)]
    for p in info["outputs"]:
        x, out_sr = wav.read_wav(p)
        assert out_sr == sr and x.shape[0] == 2 and np.isfinite(x).all()
    assert jcli.separate_main([path, "-o", str(tmp_path / "jax"), "--num-sources", "2",
                               *SMALL[2:]]) == 0
    assert json.loads(capsys.readouterr().out.strip())["target_tdoa_indexes"] == \
        info["target_tdoa_indexes"]


def test_turbo(wav_file, tmp_path, capsys):
    path, _ = wav_file
    info = _run(capsys, [path, "-o", str(tmp_path / "tb"), "--num-sources", "2", "--turbo",
                         *SMALL])
    assert len(info["outputs"]) == 2
    for p in info["outputs"]:
        assert np.isfinite(wav.read_wav(p)[0]).all()


def test_auto_sources_match_jax(wav_file, tmp_path, capsys):
    """--auto-sources takes the host 2-means, as JAX's CLI does, and writes
    one file per detected source (the default prefix: next to the input)."""
    path, _ = wav_file
    info = _run(capsys, [path, "--auto-sources", "--turbo", *SMALL])
    n = len(info["target_tdoa_indexes"])
    assert n >= 1 and info["outputs"] == [path.replace("_mix.wav", f"_sim_{i}.wav")
                                          for i in range(1, n + 1)]
    assert jcli.separate_main([path, "--auto-sources", "--turbo", *SMALL[2:]]) == 0
    assert json.loads(capsys.readouterr().out.strip())["target_tdoa_indexes"] == \
        info["target_tdoa_indexes"]


def test_several_inputs(wav_file, tmp_path, capsys):
    path, _ = wav_file
    path2 = str(tmp_path / "second_mix.wav")
    shutil.copy(path, path2)
    info = _run(capsys, [path, path2, "--num-sources", "2", "--output-prefix",
                         str(tmp_path / "multi"), *SMALL])
    assert [f["input"] for f in info["files"]] == [path, path2]
    outputs = [p for f in info["files"] for p in f["outputs"]]
    assert len(outputs) == len(set(outputs)) == 4
    for p in outputs:
        assert np.isfinite(wav.read_wav(p)[0]).all()
    # identical inputs → identical localization
    assert info["files"][0]["target_tdoa_indexes"] == info["files"][1]["target_tdoa_indexes"]


def test_runs_as_a_module(wav_file, tmp_path):
    """``python -m gccnmf_torch.cli``; with no card its default device
    raises instead of falling back to the CPU."""
    path, _ = wav_file
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "gccnmf_torch.cli", path, "--num-sources",
                          "2", "-o", str(tmp_path / "m"), *SMALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert len(json.loads(res.stdout.strip().splitlines()[-1])["outputs"]) == 2
    if not torch.cuda.is_available():
        res = subprocess.run([sys.executable, "-m", "gccnmf_torch.cli", path], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and "device='cpu'" in res.stderr
