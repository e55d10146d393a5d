"""The port's ``stream`` and ``serve`` commands (``python -m gccnmf_torch.cli
stream|serve``) on the CPU against the JAX package's ``gccnmf-stream`` and
``gccnmf-serve`` on the same seeded WAVs and dictionary: the same JSON keys,
output WAVs at the streaming oracle's bars, the dictionary from the
pretraining cache without ``--dictionary-file``, and the INI reader against
JAX's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_tpu import config as jconfig
from gccnmf_torch import cli, config
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def files(tmp_path, stereo_signal):
    """Two stereo WAVs (the test mixture, 40 blocks, and its channel swap,
    shorter) and a seeded (513, 32) dictionary."""
    mix, sr = stereo_signal
    paths = [str(tmp_path / "a_mix.wav"), str(tmp_path / "b_mix.wav")]
    wav.write_wav(mix[:, : 512 * 40], paths[0], sr)
    wav.write_wav(mix[::-1, : 512 * 25 + 100].copy(), paths[1], sr)
    dic = str(tmp_path / "W_32.npy")
    np.save(dic, np.random.default_rng(5).random((513, 32)).astype(np.float32) + 1e-3)
    return paths, dic


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got_path, want_path):
    """The streaming oracle's bars (tests/test_realtime.py), on the WAVs."""
    got, sr_g = wav.read_wav(got_path)
    want, sr_w = wav.read_wav(want_path)
    assert sr_g == sr_w and got.shape == want.shape
    err = got - want
    assert 10 * np.log10((want ** 2).sum() / max((err ** 2).sum(), 1e-30)) > 25.0
    assert (np.abs(err) < 3e-4 * np.abs(want).max()).mean() > 0.93


STREAM_FLAGS = [
    pytest.param([], id="default"),
    pytest.param(["--low-latency", "--reference-delay"], id="low-latency-reference-delay"),
    pytest.param(["--realtime", "--num-h-updates", "2"], id="realtime-h-updates"),
]


@pytest.mark.parametrize("flags", STREAM_FLAGS)
def test_stream_matches_jax_command(files, tmp_path, capsys, flags):
    (path, _), dic = files
    args = ["-i", path, "--dictionary-file", dic, *flags]
    assert cli.main(["stream", *args, "-o", str(tmp_path / "port.wav"), "--device", "cpu"]) == 0
    got = _json(capsys)
    assert jcli.stream_main([*args, "-o", str(tmp_path / "jax.wav")]) == 0
    want = _json(capsys)
    assert set(got) == set(want)
    for key in ("algorithmic_latency_ms", "blocks", "deadline_ms"):
        assert got.get(key) == want.get(key)
    _close(got["output"], want["output"])


def test_serve_int16_matches_jax_command(files, tmp_path, capsys):
    paths, dic = files
    args = ["-i", *paths, "--dictionary-file", dic, "--wire-dtype", "int16"]
    assert cli.main(["serve", *args, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = _json(capsys)
    assert jcli.serve_main([*args, "-o", str(tmp_path / "jax")]) == 0
    want = _json(capsys)
    assert set(got) == set(want)
    assert set(got["tick_ms"]) == set(want["tick_ms"])
    assert (got["streams"], got["ticks"]) == (want["streams"], want["ticks"]) == (2, 40)
    assert [os.path.basename(p) for p in got["outputs"]] == \
        ["a_mix_enhanced.wav", "b_mix_enhanced.wav"]
    for g, w in zip(got["outputs"], want["outputs"]):
        _close(g, w)


@pytest.mark.parametrize("command", ["stream", "serve"])
def test_exits_without_a_dictionary(files, tmp_path, capsys, monkeypatch, command):
    """Without --dictionary-file the command exits cleanly (0), its
    dictionary trained into the pretraining cache as JAX's command trains
    it: the same cache file (the fallback corpus is seeded) and outputs at
    the streaming oracle's bars."""
    (path, _), _ = files
    monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_ITERS", "3")
    ini = tmp_path / "s.cfg"
    ini.write_text("[NMF]\ndictionarySize = 16\n")
    outs, caches = {}, {}
    jax_main = {"stream": jcli.stream_main, "serve": jcli.serve_main}[command]
    for side, main in (("port", cli.COMMANDS[command]), ("jax", jax_main)):
        caches[side] = tmp_path / f"cache_{side}"
        monkeypatch.setenv("GCCNMF_TPU_CACHE_DIR", str(caches[side]))
        out = str(tmp_path / (f"{side}.wav" if command == "stream" else side))
        argv = ["-i", path, "-c", str(ini), "-o", out]
        if command == "serve":
            argv += ["--blocks", "8"]
        assert main(argv + (["--device", "cpu"] if side == "port" else [])) == 0
        info = _json(capsys)
        outs[side] = info["output"] if command == "stream" else info["outputs"][0]
    (name,) = os.listdir(caches["port"])
    assert os.listdir(caches["jax"]) == [name] and name.startswith("W_16_win1024_it3_s0_")
    _close(outs["port"], outs["jax"])


def test_stream_rejects_bad_block_size(files):
    (path, _), dic = files
    with pytest.raises(SystemExit):
        cli.stream_main(["-i", path, "--dictionary-file", dic, "--block-size", "300",
                         "--device", "cpu"])


def test_module_dispatches_serve(files, tmp_path):
    """``python -m gccnmf_torch.cli serve ...`` reaches serve_main, with the
    dictionary named in the INI's dictionaryFile."""
    paths, dic = files
    ini = tmp_path / "cfg.ini"
    ini.write_text(f"[NMF]\ndictionaryFile = {dic}\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "gccnmf_torch.cli", "serve", "-i", paths[1], "-c", str(ini),
         "-o", str(tmp_path / "out"), "--device", "cpu", "--blocks", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["streams"] == 1 and info["ticks"] == 4
    out, _ = wav.read_wav(info["outputs"][0])
    assert out.shape == (2, 4 * 512) and np.isfinite(out).all()


def test_load_config_matches_jax(tmp_path, caplog):
    ini = tmp_path / "cfg.ini"
    ini.write_text(
        "[TDOA]\nnumTDOAs = 32\nnumTDOAHistory = 64\ntargetTDOAEpsilon = 3.5\n"
        "localizationEnabled = false\ntargetMode = boxcar\nmicrophoneSeparationInMetres = 0.2\n"
        "[Audio]\nsampleRate = 8000\ndeviceIndex = none\n"
        "[STFT]\nwindowSize = 512\nhopSize = 128\nblockSize = 256\n"
        "[NMF]\ndictionarySize = 16\ndictionarySizes = (16, 32)\nnumHUpdates = 2\n"
        "dictionaryFile = W.npy\nbogusOption = 1\n")
    got = config.load_config(str(ini), hop_size=64, audio_path=None)
    want = jconfig.load_config(str(ini), hop_size=64, audio_path=None)
    assert vars(got) == vars(want)
    assert got.num_freq == want.num_freq and got.windows_per_block == want.windows_per_block
    assert "bogusOption" in caplog.text
    with pytest.raises(FileNotFoundError):
        config.load_config(str(tmp_path / "missing.ini"))
    ini.write_text("[STFT]\nwindowSize = none\n")
    with pytest.raises(ValueError):
        config.load_config(str(ini))
