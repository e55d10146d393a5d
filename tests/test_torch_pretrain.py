"""The port's dictionary pretraining (``gccnmf_torch/pretrain.py`` and the
``pretrain`` command) on the CPU against the JAX package's: the corpus, the
learned W, the cache key and its file, the banks, the atom ordering, the
dictionary-file checks and the command's JSON. Every comparison gives each
package a cache directory of its own: by default both resolve to the same
directory under the same key."""

import json
import os

import numpy as np
import pytest
import torch

from gccnmf_tpu import cli as jcli
from gccnmf_tpu import pretrain as jpretrain
from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_torch import cli, defs, pretrain
from gccnmf_torch.ops import nmf
from gccnmf_torch.utils import wav as wavio

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


@pytest.fixture()
def wav_file(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "case_mix.wav")
    wavio.write_wav(mix, path, sr)
    return path, sr


def _corpus(path, frames):
    return pretrain.training_corpus_from_wavs([path], 1024, 512, device="cpu")[:frames]


class TestPretrain:
    def test_corpus_from_wavs_matches_jax(self, wav_file):
        path, _ = wav_file
        got = pretrain.training_corpus_from_wavs([path, path], 1024, 512, device="cpu")
        want = jpretrain.training_corpus_from_wavs([path, path], 1024, 512)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.ndim == 2 and got.shape[1] == 513 and np.all(got >= 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def test_corpus_cap_subsamples_like_jax(self, wav_file, monkeypatch):
        """The cap (argument, else GCCNMF_TPU_PRETRAIN_MAX_FRAMES) keeps the
        same uniformly spaced frames as JAX's."""
        path, _ = wav_file
        full = pretrain.training_corpus_from_wavs([path], 1024, 512, device="cpu")
        idx = np.linspace(0, len(full) - 1, 17).astype(int)
        capped = pretrain.training_corpus_from_wavs([path], 1024, 512, max_frames=17,
                                                    device="cpu")
        np.testing.assert_array_equal(capped, full[idx])
        monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_MAX_FRAMES", "17")
        from_env = pretrain.training_corpus_from_wavs([path], 1024, 512, device="cpu")
        want = jpretrain.training_corpus_from_wavs([path], 1024, 512)
        np.testing.assert_array_equal(from_env, capped)
        assert want.shape == (17, 513)
        np.testing.assert_allclose(from_env, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def test_pretrain_matches_jax(self, wav_file, tmp_path):
        """K = 8, 5 iterations on 128 frames: W within rtol 1e-4 of JAX's, and
        the cache file has JAX's name."""
        path, _ = wav_file
        corpus = _corpus(path, 128)
        got = pretrain.pretrain_dictionary(corpus, 8, num_iterations=5,
                                           cache_dir=str(tmp_path / "port"), device="cpu")
        want = jpretrain.pretrain_dictionary(corpus, 8, num_iterations=5,
                                             cache_dir=str(tmp_path / "jax"))
        assert got.shape == want.shape == (513, 8) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
        assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")
        (name,) = os.listdir(tmp_path / "port")
        assert name == f"W_8_win1024_it5_s0_{pretrain._corpus_fingerprint(corpus)}.npy"

    def test_pretrain_and_cache(self, wav_file, tmp_path):
        path, _ = wav_file
        corpus = _corpus(path, 256)
        cache = str(tmp_path / "cache")
        w1 = pretrain.pretrain_dictionary(corpus, 16, num_iterations=5, cache_dir=cache,
                                          device="cpu")
        assert w1.shape == (513, 16)
        assert len(os.listdir(cache)) == 1
        w2 = pretrain.pretrain_dictionary(corpus, 16, num_iterations=5, cache_dir=cache,
                                          device="cpu")
        np.testing.assert_array_equal(w1, w2)

    def test_jax_cache_entry_is_loaded(self, wav_file, tmp_path, monkeypatch):
        """One cache for both packages: a W that JAX trained is the port's
        cache hit (no training), found through GCCNMF_TPU_CACHE_DIR and
        GCCNMF_TPU_PRETRAIN_ITERS as JAX finds it."""
        path, _ = wav_file
        corpus = _corpus(path, 64)
        monkeypatch.setenv("GCCNMF_TPU_CACHE_DIR", str(tmp_path / "shared"))
        monkeypatch.setenv("GCCNMF_TPU_PRETRAIN_ITERS", "3")
        want = jpretrain.pretrain_dictionary(corpus, 8)
        monkeypatch.setattr(pretrain, "corpus_nmf", None)  # a miss would call it
        got = pretrain.pretrain_dictionary(corpus, 8, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert os.listdir(tmp_path / "shared")[0].startswith("W_8_win1024_it3_s0_")

    def test_cache_keyed_by_corpus(self, wav_file, tmp_path):
        path, _ = wav_file
        corpus = _corpus(path, 256)
        cache = str(tmp_path / "cache")
        pretrain.pretrain_dictionary(corpus, 16, num_iterations=2, cache_dir=cache,
                                     device="cpu")
        pretrain.pretrain_dictionary(corpus * 2.0, 16, num_iterations=2, cache_dir=cache,
                                     device="cpu")
        assert len(os.listdir(cache)) == 2

    def test_get_dictionaries_banks_match_jax(self, wav_file, tmp_path):
        path, _ = wav_file
        corpus = _corpus(path, 128)
        got = pretrain.get_dictionaries(1024, sizes=(8, 16), train_v=corpus,
                                        cache_dir=str(tmp_path / "p"), device="cpu")
        want = jpretrain.get_dictionaries(1024, sizes=(8, 16), train_v=corpus,
                                          cache_dir=str(tmp_path / "j"))
        assert set(got) == {"Pretrained", "Random"}
        assert got["Pretrained"][8].shape == (513, 8)
        assert got["Random"][16].shape == (513, 16)
        for size in (8, 16):
            np.testing.assert_array_equal(got["Random"][size], want["Random"][size])
            np.testing.assert_allclose(got["Pretrained"][size], want["Pretrained"][size],
                                       rtol=1e-4, atol=1e-6)
        w = got["Pretrained"][16]  # ordered by spectral centroid
        cents = (np.arange(513)[:, None] * w).sum(0) / w.sum(0)
        assert np.all(np.diff(cents) >= -1e-3)

    def test_mesh_is_not_ported(self, wav_file, tmp_path):
        """``mesh=`` is ported: over this process's world of one (gloo) the
        port trains W as JAX does over its one-device mesh, and as it does
        itself without a mesh (rtol 1e-4), under the same cache key."""
        import jax
        import torch.distributed as dist

        from gccnmf_tpu.parallel import mesh as jmesh
        from gccnmf_torch.parallel import mesh as mesh_lib

        corpus = _corpus(wav_file[0], 128)
        want = jpretrain.pretrain_dictionary(
            corpus, 8, num_iterations=5, cache_dir=str(tmp_path / "jax"),
            mesh=jmesh.make_mesh(data=1, model=1, devices=jax.devices()[:1]))
        alone = pretrain.pretrain_dictionary(corpus, 8, num_iterations=5,
                                             cache_dir=str(tmp_path / "alone"), device="cpu")
        try:
            got = pretrain.pretrain_dictionary(corpus, 8, num_iterations=5,
                                               cache_dir=str(tmp_path / "port"),
                                               mesh=mesh_lib.make_mesh(device="cpu"))
        finally:
            dist.destroy_process_group()
        for ref in (want, alone):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max())
        assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")

    def test_silent_corpus_frame_follows_jax_unguarded(self, wav_file, tmp_path):
        """On the CPU the port trains with JAX's unguarded updates: a frame of
        digital silence takes W to NaN in both (the card's guarded kernel
        keeps W finite instead: tests/test_torch_cuda.py)."""
        path, _ = wav_file
        corpus = _corpus(path, 32).copy()
        corpus[5] = 0.0
        got = pretrain.pretrain_dictionary(corpus, 4, num_iterations=3,
                                           cache_dir=str(tmp_path / "p"), device="cpu")
        want = jpretrain.pretrain_dictionary(corpus, 4, num_iterations=3,
                                             cache_dir=str(tmp_path / "j"))
        assert np.isnan(want).all() and np.isnan(got).all()

    def test_default_cache_dir_is_jax_default(self):
        from gccnmf_tpu import defs as jdefs

        assert defs.PRETRAINED_W_DIR == jdefs.PRETRAINED_W_DIR


class TestCacheAndFiles:
    def test_fingerprint_covers_every_row(self):
        rng = np.random.default_rng(0)
        a = rng.random((2000, 64)).astype(np.float32)
        b = a.copy()
        b[1] += 1e-3
        assert pretrain._corpus_fingerprint(a) != pretrain._corpus_fingerprint(b)
        assert pretrain._corpus_fingerprint(a) == pretrain._corpus_fingerprint(a.copy())
        assert pretrain._corpus_fingerprint(a) == jpretrain._corpus_fingerprint(a)

    def test_cache_publish_is_atomic(self, wav_file, tmp_path):
        path, _ = wav_file
        corpus = _corpus(path, 128)
        cache = str(tmp_path / "cache")
        pretrain.pretrain_dictionary(corpus, 8, num_iterations=2, cache_dir=cache,
                                     device="cpu")
        names = os.listdir(cache)
        assert len(names) == 1 and names[0].endswith(".npy")
        assert ".tmp" not in names[0]
        assert np.load(os.path.join(cache, names[0])).shape == (513, 8)

    def test_order_atoms_by_centroid_matches_jax(self, rng):
        w = rng.random((513, 24)).astype(np.float32)
        np.testing.assert_array_equal(nmf.order_atoms_by_centroid(w),
                                      jnmf.order_atoms_by_centroid(w))

    @pytest.mark.parametrize("case", ["rank", "rows", "negative"])
    def test_dictionary_file_errors_match_jax(self, tmp_path, case):
        arr = {"rank": np.ones((3, 4, 5), np.float32), "rows": np.ones((100, 8), np.float32),
               "negative": -np.ones((513, 8), np.float32)}[case]
        path = str(tmp_path / f"{case}.npy")
        np.save(path, arr)
        with pytest.raises(ValueError) as want:
            jpretrain.load_dictionary_file(path, num_freq=513)
        with pytest.raises(ValueError) as got:
            pretrain.load_dictionary_file(path, num_freq=513)
        assert str(got.value) == str(want.value)

    def test_dictionary_file_loads_float32(self, tmp_path):
        path = str(tmp_path / "W.npy")
        np.save(path, np.ones((513, 8), np.float64))
        w = pretrain.load_dictionary_file(path, num_freq=513)
        assert w.dtype == np.float32 and w.flags["C_CONTIGUOUS"]


class TestPretrainCLI:
    def test_pretrain_cli_matches_jax(self, wav_file, tmp_path, capsys):
        """The command trains the sizes into the cache with JAX's JSON and
        file names; a second run hits the cache (the same files, no
        training). The two corpora come from two FFTs and differ in the last
        bits, so each name ends in the fingerprint of its own package's
        corpus (the same corpus gets the same name: test_pretrain_matches_jax)."""
        path, _ = wav_file
        base = [path, "--sizes", "8", "16", "--num-iterations", "3", "--max-frames", "128"]
        port, jax_cache = str(tmp_path / "port"), str(tmp_path / "jax")
        assert cli.main(["pretrain", *base, "--cache-dir", port, "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert jcli.pretrain_main([*base, "--cache-dir", jax_cache]) == 0
        want = json.loads(capsys.readouterr().out.strip())
        assert got["dictionaries"] == want["dictionaries"] == {"8": [513, 8], "16": [513, 16]}
        assert {k: v for k, v in got.items() if k != "cache_dir"} == \
            {k: v for k, v in want.items() if k != "cache_dir"}
        tag = pretrain._corpus_fingerprint(pretrain.training_corpus_from_wavs(
            [path], max_frames=128, device="cpu"))
        cached = sorted(os.listdir(port))
        assert cached == [f"W_{k}_win1024_it3_s0_{tag}.npy" for k in (16, 8)]
        jax_cached = sorted(os.listdir(jax_cache))
        assert [n.rsplit("_", 1)[0] for n in jax_cached] == [n.rsplit("_", 1)[0] for n in cached]
        for name, jax_name in zip(cached, jax_cached):
            np.testing.assert_allclose(np.load(os.path.join(port, name)),
                                       np.load(os.path.join(jax_cache, jax_name)), rtol=1e-4,
                                       atol=1e-6)
        stamps = {n: os.stat(os.path.join(port, n)).st_mtime_ns for n in cached}
        assert cli.pretrain_main([*base, "--cache-dir", port, "--device", "cpu"]) == 0
        assert {n: os.stat(os.path.join(port, n)).st_mtime_ns for n in cached} == stamps

    def test_pretrain_save_dir_to_dictionary_file_handoff(self, wav_file, tmp_path, capsys,
                                                          monkeypatch):
        """``pretrain --save-dir`` exports W_<size>.npy, which the other
        commands load through --dictionary-file without pretraining."""
        path, _ = wav_file
        save = tmp_path / "dicts"
        assert cli.pretrain_main([path, "--sizes", "16", "--num-iterations", "3",
                                  "--max-frames", "128", "--cache-dir", str(tmp_path / "c"),
                                  "--save-dir", str(save), "--device", "cpu"]) == 0
        info = json.loads(capsys.readouterr().out.strip())
        assert info["saved"] == [str(save / "W_16.npy")]

        def _no_pretrain(*a, **k):
            raise AssertionError("pretraining ran despite --dictionary-file")

        monkeypatch.setattr(pretrain, "get_dictionaries", _no_pretrain)
        assert cli.stream_main(["-i", path, "-o", str(tmp_path / "o.wav"), "--device", "cpu",
                                "--dictionary-file", str(save / "W_16.npy")]) == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert os.path.exists(out["output"])

    def test_data_shards_exits(self, wav_file, tmp_path, capsys):
        """``--data-shards 2`` no longer exits naming Queue 1 item 6b: it
        trains over a world of two CPU ranks, exits 0 with the command's
        JSON, and gives the one-device W (rtol 2e-3, atol 2e-5: the JAX
        suite's bar for --data-shards)."""
        path, _ = wav_file
        base = [path, "--sizes", "8", "--num-iterations", "3", "--max-frames", "128",
                "--device", "cpu"]
        for name, flags in (("one", []), ("two", ["--data-shards", "2"])):
            assert cli.main(["pretrain", *base, "--cache-dir", str(tmp_path / name),
                             "--save-dir", str(tmp_path / f"{name}_w"), *flags]) == 0
            info = json.loads(capsys.readouterr().out.strip())
            assert info["dictionaries"] == {"8": [513, 8]}
        np.testing.assert_allclose(np.load(tmp_path / "two_w" / "W_8.npy"),
                                   np.load(tmp_path / "one_w" / "W_8.npy"), rtol=2e-3, atol=2e-5)
