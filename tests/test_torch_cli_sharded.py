"""The commands over a world of ranks on the CPU: ``separate --time-shards
N`` (in memory and ``--streamed``) and ``pretrain --data-shards N``,
against ``gccnmf_tpu.cli`` with the same flags on the 8-device virtual
mesh: JAX's JSON keys and targets, finite stereo files within 3 PCM steps
of JAX's, and the one-device dictionary within rtol 2e-3, atol 2e-5 (the
JAX suite's bar, tests/test_cli_pretrain.py:474-490)."""

import json
import os

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_torch import cli
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # the suite runs several xdist workers

PCM_TOL = 3.0 / 32768.0
SMALL = ["--dictionary-size", "16", "--num-iterations", "5", "--num-sources", "2"]


@pytest.fixture()
def wav_file(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "case_mix.wav")
    wav.write_wav(mix, path, sr)
    return path


def _both(capsys, tmp_path, inputs, flags):
    """The port's command on the CPU and JAX's → their JSON lines."""
    assert cli.separate_main([*inputs, "-o", str(tmp_path / "port"), "--device", "cpu",
                              *SMALL, *flags]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.separate_main([*inputs, "-o", str(tmp_path / "jax"), *SMALL, *flags]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


def _hold_files(got, want):
    assert set(got) == set(want) == {"outputs", "target_tdoa_indexes"}
    assert got["target_tdoa_indexes"] == want["target_tdoa_indexes"]
    assert len(got["outputs"]) == 2
    for p, q in zip(got["outputs"], want["outputs"], strict=True):
        (a, sr_a), (b, sr_b) = wav.read_wav(p), wav.read_wav(q)
        assert sr_a == sr_b == 16000 and a.shape == b.shape and a.shape[0] == 2
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=PCM_TOL)


def test_separate_time_shards_streamed(wav_file, tmp_path, capsys):
    got, want = _both(capsys, tmp_path, [wav_file], ["--time-shards", "2", "--streamed"])
    assert got["outputs"] == [str(tmp_path / f"port_sim_{i}.wav") for i in (1, 2)]
    _hold_files(got, want)


def test_separate_time_shards_in_memory_two_files(wav_file, tmp_path, capsys):
    """Two inputs in one world: the per-file JSON shape, each file JAX's."""
    second = str(tmp_path / "other_mix.wav")
    x, sr = wav.read_wav(wav_file)
    wav.write_wav(x[:, ::-1].copy(), second, sr)
    got, want = _both(capsys, tmp_path, [wav_file, second], ["--time-shards", "2"])
    assert [f["input"] for f in got["files"]] == [wav_file, second]
    for g, w in zip(got["files"], want["files"], strict=True):
        assert g.pop("input") == w.pop("input")
        _hold_files(g, w)


def test_separate_time_shards_device_init(wav_file, tmp_path, capsys):
    """--device-init over 2 shards: JAX's targets, finite nonzero files."""
    got, want = _both(capsys, tmp_path, [wav_file],
                      ["--time-shards", "2", "--streamed", "--device-init"])
    assert got["target_tdoa_indexes"] == want["target_tdoa_indexes"]
    for p in got["outputs"]:
        x, _ = wav.read_wav(p)
        assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_pretrain_data_shards(wav_file, tmp_path, capsys):
    """--data-shards 4 trains over 4 CPU ranks: the one-device W and JAX's
    --data-shards 4 W within rtol 2e-3, atol 2e-5; the same JSON."""
    base = [wav_file, "--sizes", "8", "--num-iterations", "3", "--max-frames", "128"]
    commands = {"one": (cli.main, ["pretrain", *base, "--device", "cpu"]),
                "four": (cli.main, ["pretrain", *base, "--device", "cpu", "--data-shards", "4"]),
                "jax": (jcli.pretrain_main, [*base, "--data-shards", "4"])}
    runs = {}
    for name, (main, argv) in commands.items():
        cache = str(tmp_path / name)
        assert main([*argv, "--cache-dir", cache]) == 0
        info = json.loads(capsys.readouterr().out.strip())
        (entry,) = os.listdir(cache)
        runs[name] = (info, np.load(os.path.join(cache, entry)))
    assert runs["four"][0] == {**runs["jax"][0], "cache_dir": str(tmp_path / "four")}
    for ref in ("one", "jax"):
        np.testing.assert_allclose(runs["four"][1], runs[ref][1], rtol=2e-3, atol=2e-5)
