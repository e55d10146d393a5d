"""The port's ``realtime`` command (``python -m gccnmf_torch.cli realtime``)
on the CPU against the JAX package's ``gccnmf-realtime`` (``realtime_main``)
on the same WAV and ``--dictionary-file``: the same JSON keys, the output
WAV at the streaming oracle's bars, the flag errors of JAX's command, the
live-output fallback, ``--gui`` reaching the port's window, and the
pretraining cache without ``--dictionary-file`` (the bars of
tests/test_cli_pretrain.py's ``test_realtime_cli`` and
tests/test_live_audio.py)."""

import json

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_torch import cli
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


@pytest.fixture()
def files(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "mix.wav")
    wav.write_wav(mix[:, : 512 * 30], path, sr)
    dic = str(tmp_path / "W_16.npy")
    np.save(dic, np.random.default_rng(5).random((513, 16)).astype(np.float32) + 1e-3)
    return path, dic


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got_path, want_path):
    """The streaming oracle's bars, on the WAVs."""
    got, sr_g = wav.read_wav(got_path)
    want, sr_w = wav.read_wav(want_path)
    assert sr_g == sr_w and got.shape == want.shape
    err = got - want
    assert 10 * np.log10((want ** 2).sum() / max((err ** 2).sum(), 1e-30)) > 25.0
    assert (np.abs(err) < 3e-4 * np.abs(want).max()).mean() > 0.93


@pytest.mark.parametrize("flags", [[], ["--blocks", "12", "--pipeline-depth", "2"],
                                   ["--streamed-output", "--no-gui"]],
                         ids=["whole-file", "blocks-pipelined", "streamed-output"])
def test_realtime_against_jax(files, tmp_path, capsys, flags):
    path, dic = files
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", lambda a: jcli.realtime_main(a[1:]), [])):
        out = str(tmp_path / f"{name}.wav")
        assert main(["realtime", "-i", path, "-o", out, "--dictionary-file", dic,
                     *flags, *extra]) == 0
        outs[name] = _json(capsys)
    assert set(outs["port"]) == set(outs["jax"])
    assert outs["port"]["blocks"] == outs["jax"]["blocks"] == (12 if "--blocks" in flags else 30)
    assert outs["port"]["deadline_ms"] == outs["jax"]["deadline_ms"] == pytest.approx(32.0)
    _close(outs["port"]["output"], outs["jax"]["output"])


@pytest.mark.parametrize("argv,message", [
    (["--live", "--blocks", "4"], "host audio stack"),
    (["--live"], "host audio stack"),
    (["--loop"], "--loop requires --blocks"),
], ids=["live-no-audio-stack", "live-no-blocks", "loop-without-blocks"])
def test_flag_errors_match_jax(files, capsys, argv, message):
    """--live without sounddevice and --loop without --blocks stop with
    argparse's usage error (exit 2), as JAX's command does."""
    path, dic = files
    for run in (lambda a: cli.main(["realtime", *a, "--device", "cpu"]), jcli.realtime_main):
        with pytest.raises(SystemExit) as exc:
            run(["-i", path, "--dictionary-file", dic, *argv])
        assert exc.value.code == 2
        assert message in capsys.readouterr().err


def test_live_output_falls_back_to_the_file(files, tmp_path, capsys):
    """--live-output without an audio stack writes -o and reports no
    stream counters."""
    path, dic = files
    out = str(tmp_path / "o.wav")
    assert cli.main(["realtime", "-i", path, "-o", out, "--dictionary-file", dic,
                     "--live-output", "--blocks", "6", "--device", "cpu"]) == 0
    info = _json(capsys)
    assert info["output"] == out and info["blocks"] == 6
    assert "output_underruns" not in info
    assert wav.read_wav(out)[0].shape == (2, 6 * 512)


def test_gui_flag_reaches_the_ports_window(files, monkeypatch):
    """--gui builds the port's window through gccnmf_torch.gui.run_gui, with
    the config carrying --dictionary-file, looping unless --no-loop, on the
    requested device."""
    import gccnmf_torch.gui as gui

    path, dic = files
    calls = []
    monkeypatch.setattr(gui, "run_gui", lambda *a, **k: calls.append((a, k)))
    assert cli.main(["realtime", "-i", path, "--dictionary-file", dic, "--gui",
                     "--device", "cpu"]) == 0
    assert cli.main(["realtime", "-i", path, "--gui", "--no-loop"]) == 0
    (args, kw), (args2, kw2) = calls
    assert args == (path,) and kw["loop"] is True and kw["device"] == "cpu"
    assert kw["config"].dictionary_file == dic
    assert kw2["loop"] is False and kw2["device"] == "cuda"


def test_default_device_is_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path, dic = files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["realtime", "-i", path, "--dictionary-file", dic, "--blocks", "2"])


def test_realtime_from_the_pretraining_cache(files, tmp_path, capsys, monkeypatch):
    """Without --dictionary-file the app trains W into the cache (JAX's
    test_realtime_cli): an INI config picks the size."""
    path, _ = files
    monkeypatch.setenv("GCCNMF_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_ITERS", "3")
    monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_MAX_FRAMES", "512")
    cfgp = tmp_path / "s.cfg"
    cfgp.write_text("[NMF]\ndictionarySize = 16\ndictionarySizes = [16]\n")
    assert cli.main(["realtime", "-i", path, "-c", str(cfgp), "-o", str(tmp_path / "rt.wav"),
                     "--blocks", "8", "--no-gui", "--device", "cpu"]) == 0
    info = _json(capsys)
    assert info["blocks"] == 8 and info["deadline_ms"] == pytest.approx(32.0)
    out, _ = wav.read_wav(info["output"])
    assert out.shape == (2, 8 * 512) and np.isfinite(out).all()
    assert any(p.name.startswith("W_16_") for p in (tmp_path / "cache").iterdir())
