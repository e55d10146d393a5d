"""The port's ``enhance`` command (``python -m gccnmf_torch.cli enhance``) on
the CPU against the JAX package's ``gccnmf-enhance`` on the same seeded WAV
and dictionary file, in both modes; several inputs, the ``-o`` and mono
rejections, and the dictionary taken from the pretraining cache."""

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
from gccnmf_torch.models.online import OnlineConfig, OnlineGCCNMFEnhancer
from gccnmf_torch.utils import wav

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
PCM_STEP = 2.0 ** -15


@pytest.fixture()
def files(tmp_path, stereo_signal):
    """The test mixture as a WAV in a directory of the port's and one of
    JAX's (outputs land next to the input), and a seeded (513, 32)
    dictionary."""
    mix, sr = stereo_signal
    paths = []
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        paths.append(str(tmp_path / side / "case_mix.wav"))
        wav.write_wav(mix, paths[-1], sr)
    dic = str(tmp_path / "W_32.npy")
    np.save(dic, np.random.default_rng(5).random((513, 32)).astype(np.float32) + 1e-3)
    return paths, dic


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _snr_db(ref, est):
    return 10 * np.log10((ref ** 2).sum() / max(((ref - est) ** 2).sum(), 1e-30))


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_enhance_matches_jax_command(files, capsys, mode):
    """The same JSON and output name. Online: the WAV within 1e-4 x max of
    JAX's plus one PCM step (the 16-bit writer may round a sample across a
    step); offline: above 25 dB (the enhancement bar)."""
    (port_path, jax_path), dic = files
    flags = ["--mode", mode, "--dictionary-file", dic]
    assert cli.main(["enhance", port_path, *flags, "--device", "cpu"]) == 0
    got = _json(capsys)
    assert jcli.enhance_main([jax_path, *flags]) == 0
    want = _json(capsys)
    assert set(got) == set(want) == {"output"}
    assert os.path.basename(got["output"]) == os.path.basename(want["output"]) == \
        "case_mix_enhanced.wav"
    out, sr = wav.read_wav(got["output"])
    ref, sr_ref = wav.read_wav(want["output"])
    assert sr == sr_ref and out.shape == ref.shape and np.isfinite(out).all()
    if mode == "online":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max() + PCM_STEP)
    else:
        assert _snr_db(ref, out) > 25.0


def test_enhance_output_is_the_enhancers(files, tmp_path, capsys):
    """``-o`` names the output; it holds the online enhancer's result as the
    16-bit writer stores it."""
    (path, _), dic = files
    out_path = str(tmp_path / "e.wav")
    assert cli.enhance_main([path, "-o", out_path, "--dictionary-file", dic, "--num-h-updates",
                             "2", "--device", "cpu"]) == 0
    assert _json(capsys) == {"output": out_path}
    stereo, sr = wav.read_wav(path)
    enh = OnlineGCCNMFEnhancer(np.load(dic), OnlineConfig(sample_rate=sr, num_h_updates=2),
                               device="cpu")
    wav.write_wav(enh.enhance(stereo)["enhanced"], str(tmp_path / "want.wav"), sr)
    np.testing.assert_array_equal(wav.read_wav(out_path)[0],
                                  wav.read_wav(str(tmp_path / "want.wav"))[0])


def test_enhance_multiple_inputs(files, tmp_path, capsys):
    """Several files in one call share one enhancer and write
    <input>_enhanced.wav each; -o with several inputs is a usage error."""
    (path, _), dic = files
    path2 = str(tmp_path / "port" / "second.wav")
    shutil.copy(path, path2)
    assert cli.enhance_main([path, path2, "--mode", "offline", "--dictionary-file", dic,
                             "--device", "cpu"]) == 0
    info = _json(capsys)
    assert [os.path.basename(p) for p in info["outputs"]] == \
        ["case_mix_enhanced.wav", "second_enhanced.wav"]
    a, b = (wav.read_wav(p)[0] for p in info["outputs"])
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit) as exc:
        cli.enhance_main([path, path2, "-o", str(tmp_path / "x.wav"), "--dictionary-file", dic,
                          "--device", "cpu"])
    assert exc.value.code == 2


def test_enhance_rejects_mono(tmp_path, files):
    _, dic = files
    mono = str(tmp_path / "mono.wav")
    wav.write_wav(np.zeros((1, 8192), np.float32) + 0.01, mono, 16000)
    with pytest.raises(SystemExit, match="stereo"):
        cli.enhance_main([mono, "--dictionary-file", dic, "--device", "cpu"])


def test_enhance_takes_the_pretrained_dictionary(files, tmp_path, capsys, monkeypatch):
    """Without --dictionary-file the dictionary comes from the pretraining
    cache, as JAX's does: the same cache file name (the fallback corpus is
    seeded, so both fingerprint the same bytes) and W within rtol 1e-4."""
    (port_path, jax_path), _ = files
    monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_ITERS", "3")
    ini = tmp_path / "s.cfg"
    ini.write_text("[NMF]\ndictionarySize = 16\n")
    caches = {}
    for side, path, run in (("port", port_path, cli.enhance_main),
                            ("jax", jax_path, jcli.enhance_main)):
        caches[side] = tmp_path / f"cache_{side}"
        monkeypatch.setenv("GCCNMF_TPU_CACHE_DIR", str(caches[side]))
        argv = [path, "-c", str(ini)] + (["--device", "cpu"] if side == "port" else [])
        assert run(argv) == 0
        capsys.readouterr()
    (name,) = os.listdir(caches["port"])
    assert os.listdir(caches["jax"]) == [name] and name.startswith("W_16_win1024_it3_s0_")
    np.testing.assert_allclose(np.load(caches["port"] / name), np.load(caches["jax"] / name),
                               rtol=1e-4, atol=1e-6)


def test_module_dispatches_enhance(files, tmp_path):
    """``python -m gccnmf_torch.cli enhance ...`` reaches enhance_main."""
    (path, _), dic = files
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "gccnmf_torch.cli", "enhance", path, "-o",
         str(tmp_path / "m.wav"), "--dictionary-file", dic, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    out, _ = wav.read_wav(info["output"])
    assert out.shape[0] == 2 and np.isfinite(out).all()
