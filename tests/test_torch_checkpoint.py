"""The port's NMF checkpoints (``gccnmf_torch/checkpoint.py``) on the CPU:
the cases of ``tests/test_runtime.py``'s checkpoint tests, and the file as
the bridge between the packages: a checkpoint JAX wrote resumes in the port,
and one the port wrote resumes in JAX."""

import os

import numpy as np
import pytest
import torch

from gccnmf_tpu import checkpoint as jcheckpoint
from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_torch import checkpoint
from gccnmf_torch.convert import nmf_state_from_numpy
from gccnmf_torch.ops import nmf

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def _problem():
    rng = np.random.default_rng(3)
    v = (rng.random((40, 33)) + 0.05).astype(np.float32)
    w0, h0 = nmf.nmf_init_numpy(33, 8, 40)
    return v, w0, h0


def _run(v, w0, h0, iters, ck, every):
    return checkpoint.kl_nmf_checkpointed(v, w0, h0, iters, ck, checkpoint_every=every,
                                          device="cpu")


def test_checkpointed_matches_straight_run(tmp_path):
    """Chunks of 7 equal one 20-iteration run, bit for bit (the same
    updates), and JAX's at rtol 2e-4."""
    v, w0, h0 = _problem()
    w_ck, h_ck = _run(v, w0, h0, 20, str(tmp_path / "ck"), 7)
    w_ref, h_ref = nmf.kl_nmf(*(torch.from_numpy(x) for x in (v, w0, h0)), 20)
    assert torch.equal(w_ck, w_ref) and torch.equal(h_ck, h_ref)
    w_jax, _ = jnmf.kl_nmf(v, w0, h0, 20)
    np.testing.assert_allclose(w_ck.numpy(), np.asarray(w_jax), rtol=2e-4)


def test_resume_after_interruption(tmp_path):
    v, w0, h0 = _problem()
    ck = str(tmp_path / "ck")
    _run(v, w0, h0, 10, ck, 5)  # an "interrupted" run: 10 of 20 iterations
    _, _, it = checkpoint.load_nmf_state(checkpoint.latest_checkpoint(ck))
    assert it == 10
    _run(v, w0, h0, 20, ck, 5)  # a higher target in the same dir: continues from 10
    files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    assert files == ["nmf_000005.npz", "nmf_000010.npz", "nmf_000015.npz", "nmf_000020.npz"]
    w_final, _, _ = checkpoint.load_nmf_state(os.path.join(ck, "nmf_000020.npz"))
    w_re, _ = _run(v, w0, h0, 20, ck, 5)  # the finished job again: a no-op
    np.testing.assert_array_equal(w_re.numpy(), w_final)


def test_resume_past_target_raises(tmp_path):
    v, w0, h0 = _problem()
    ck = str(tmp_path / "ck")
    _run(v, w0, h0, 20, ck, 5)
    with pytest.raises(ValueError, match="past"):
        _run(v, w0, h0, 10, ck, 5)
    _run(v, w0, h0, 20, ck, 5)  # the exact target stays a no-op


def test_mismatched_meta_rejected(tmp_path):
    v, w0, h0 = _problem()
    ck = str(tmp_path / "ck")
    _run(v, w0, h0, 5, ck, 5)
    path = checkpoint.latest_checkpoint(ck)
    with pytest.raises(ValueError, match="different problem"):
        checkpoint.load_nmf_state(path, expect_meta=dict(sparsity_alpha=0.5, v_shape=[40, 33]))


def test_latest_pointer_tolerates_damage(tmp_path):
    ck = tmp_path / "ck"
    assert checkpoint.latest_checkpoint(str(ck)) is None
    ck.mkdir()
    (ck / "latest").write_text("")
    assert checkpoint.latest_checkpoint(str(ck)) is None
    (ck / "latest").write_text("nmf_000005.npz")  # names a missing file
    assert checkpoint.latest_checkpoint(str(ck)) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """10 iterations written by one package, resumed to 20 by the other:
    the same files and fingerprint, and the result within rtol 1e-4 of the
    resuming package's uninterrupted run."""
    v, w0, h0 = _problem()
    ck = str(tmp_path / "ck")
    if writer == "jax":
        jcheckpoint.kl_nmf_checkpointed(v, w0, h0, 10, ck, checkpoint_every=5)
        w, h = _run(v, w0, h0, 20, ck, 5)
        want, _ = nmf.kl_nmf(*(torch.from_numpy(x) for x in (v, w0, h0)), 20)
        got = w.numpy()
    else:
        _run(v, w0, h0, 10, ck, 5)
        w, h = jcheckpoint.kl_nmf_checkpointed(v, w0, h0, 20, ck, checkpoint_every=5)
        want, _ = jnmf.kl_nmf(v, w0, h0, 20)
        got = np.asarray(w)
    files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
    assert files == ["nmf_000005.npz", "nmf_000010.npz", "nmf_000015.npz", "nmf_000020.npz"]
    assert str(np.load(os.path.join(ck, files[0]))["meta"]) == \
        str(np.load(os.path.join(ck, files[-1]))["meta"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-7)


def test_nmf_state_from_numpy_checks():
    w, h = np.ones((33, 8), np.float32), np.ones((40, 8), np.float32)
    tw, th = nmf_state_from_numpy(w, h)
    assert tw.dtype == th.dtype == torch.float32 and tuple(th.shape) == (40, 8)
    tw[0, 0] = 5.0
    assert w[0, 0] == 1.0  # a copy
    with pytest.raises(TypeError, match="float32"):
        nmf_state_from_numpy(w.astype(np.float64), h)
    with pytest.raises(ValueError, match="rank 2"):
        nmf_state_from_numpy(w[None], h)
    with pytest.raises(ValueError, match="disagree on K"):
        nmf_state_from_numpy(w, h[:, :4])
