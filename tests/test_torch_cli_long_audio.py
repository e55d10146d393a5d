"""The separate command's long-audio flags (``--streamed``,
``--time-shards 1``, ``--chunk-frames``, ``--device-init``) on the CPU,
against ``gccnmf_tpu.cli.separate_main`` with the same flags: the same JSON
line and the same files within 3 PCM steps."""

import json

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_torch import cli
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

PCM_TOL = 3.0 / 32768.0
SMALL = ["--dictionary-size", "32", "--num-iterations", "30", "--num-tdoas", "64",
         "--num-sources", "2"]


@pytest.fixture()
def wav_file(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "case_mix.wav")
    wav.write_wav(mix, path, sr)
    return path


def _both(capsys, tmp_path, path, flags):
    """The port's command on the CPU and JAX's with ``flags`` → their JSON
    lines, each with its own output prefix."""
    assert cli.separate_main([path, "-o", str(tmp_path / "port"), "--device", "cpu", *SMALL,
                              *flags]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.separate_main([path, "-o", str(tmp_path / "jax"), *SMALL, *flags]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


@pytest.mark.parametrize("flags", [["--streamed", "--chunk-frames", "64"],
                                   ["--time-shards", "1"]],
                         ids=["streamed", "time-shards-1"])
def test_long_audio_flags_match_jax(wav_file, tmp_path, capsys, flags):
    got, want = _both(capsys, tmp_path, wav_file, flags)
    assert set(got) == set(want) == {"outputs", "target_tdoa_indexes"}
    assert got["target_tdoa_indexes"] == want["target_tdoa_indexes"]
    assert got["outputs"] == [str(tmp_path / f"port_sim_{i}.wav") for i in (1, 2)]
    for p, q in zip(got["outputs"], want["outputs"], strict=True):
        (a, sr_a), (b, sr_b) = wav.read_wav(p), wav.read_wav(q)
        assert sr_a == sr_b == 16000 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PCM_TOL)


def test_device_init_runs_streamed(wav_file, tmp_path, capsys):
    """--device-init with --streamed: JAX's targets, finite nonzero files."""
    got, want = _both(capsys, tmp_path, wav_file, ["--streamed", "--device-init"])
    assert got["target_tdoa_indexes"] == want["target_tdoa_indexes"]
    for p in got["outputs"]:
        x, _ = wav.read_wav(p)
        assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_device_init_alone_is_an_argparse_error(wav_file, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.separate_main([wav_file, "--device", "cpu", "--device-init"])
    assert exc.value.code == 2
    assert "--device-init requires --streamed or --time-shards" in capsys.readouterr().err


def test_more_time_shards_exit_naming_item_6b(wav_file, tmp_path):
    """More time shards than one no longer exit naming Queue 1 item 6b: they
    run over a world of ranks on the card unless --device cpu says
    otherwise, and never move to the CPU. With more shards than cards they
    raise before anything is written (tests/test_torch_cli_sharded.py runs
    them on the CPU)."""
    shards = str(max(2, torch.cuda.device_count() + 1))
    for flags in (["--time-shards", shards], ["--time-shards", shards, "--streamed"]):
        with pytest.raises((RuntimeError, ValueError), match="CUDA is not available|exceeds"):
            cli.separate_main([wav_file, "-o", str(tmp_path / "x"), *flags])
    assert not (tmp_path / "x_sim_1.wav").exists()


def test_streamed_rejects_mono_from_the_header(tmp_path):
    mono = str(tmp_path / "mono_mix.wav")
    wav.write_wav(np.zeros((1, 8192), np.float32) + 0.01, mono, 16000)
    with pytest.raises(SystemExit, match="expected 2-channel audio, got 1 channel"):
        cli.separate_main([mono, "--device", "cpu", "--streamed"])
