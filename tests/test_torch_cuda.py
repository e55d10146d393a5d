"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card (decided inside
the ``cuda`` fixture, never at import). The file imports no JAX, so it runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (no dimension a multiple of the tiles) so the
masked edges are exercised; chip_smoke.py repeats the comparison at the
reference shapes.
"""

import json

import numpy as np
import pytest
import torch

from gccnmf_torch import checkpoint, cli, pretrain
from gccnmf_torch.config import GCCNMFConfig
from gccnmf_torch.models.offline import GCCNMFEnhancer, GCCNMFSeparator, OfflineConfig
from gccnmf_torch.models.online import OnlineConfig, OnlineGCCNMFEnhancer
from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig, StreamParams
from gccnmf_torch.serving import StreamServer, StreamSettings, float_to_pcm
from gccnmf_torch.ops import gcc, masks
from gccnmf_torch.ops import stft as stft_ops
from gccnmf_torch.ops.enhance_cuda import (
    argmax_flips, soft_mask_basis, soft_mask_cuda, soft_mask_plain,
    tf_synthesis_basis, tf_synthesis_cuda, tf_synthesis_plain,
)
from gccnmf_torch.ops.frontend_cuda import (
    frontend_basis, stft_gcc_frontend_cuda, stft_gcc_frontend_plain,
)
from gccnmf_torch.ops.nmf import kl_divergence, kl_nmf, kl_nmf_simul, nmf_init_numpy
from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain
from gccnmf_torch.ops.synthesis_cuda import (
    masked_synthesis_cuda, masked_synthesis_plain, synthesis_basis,
)
from gccnmf_torch.ops.windows import hann_symmetric
from gccnmf_torch.parallel.long_audio import LongAudioSeparator
from gccnmf_torch.parallel.mesh import local_mesh
from gccnmf_torch.utils import wav

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    """The card, decided inside the test (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32
    return torch.device("cuda")


def _kl(v, w, h):
    return float(kl_divergence(v, w.double(), h.double()))


def _nmf_problem(dev, b=2, t=300, f=65, k=24, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.random((t, 4)) + 0.1) @ (rng.random((f, 4)) + 0.1).T + 0.01
    v = np.stack([v * (1 + i) for i in range(b)]).astype(np.float32)
    w0, h0 = nmf_init_numpy(f, k, t)
    return (torch.as_tensor(v, device=dev), torch.as_tensor(w0, device=dev).expand(b, f, k),
            torch.as_tensor(h0, device=dev).expand(b, t, k))


# (T, F, K) at every ragged edge of the tensor-core tiles (128 rows, 64 or
# 128 columns, 64-deep slices): T not a multiple of 128 (300, 517), F odd
# (65; 513 at a small T), K = 24 and K = 136 (more than one 128-wide tile)
NMF_SHAPES = [(300, 65, 24), (517, 65, 136), (96, 513, 24)]


@pytest.mark.parametrize("shape", NMF_SHAPES, ids=lambda s: "t%d-f%d-k%d" % s)
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "bfloat16_q", "bfloat16_q_simul"])
def test_nmf_kernel_matches_plain(cuda, mode, shape):
    t, f, k = shape
    v, w0, h0 = _nmf_problem(cuda, b=3, t=t, f=f, k=k)
    w, h = kl_nmf_cuda(v, w0, h0, 15, matmul_dtype=mode)
    w2, h2 = kl_nmf_cuda(v, w0, h0, 15, matmul_dtype=mode)
    assert torch.equal(w, w2) and torch.equal(h, h2)  # fixed-order sums, no atomics
    for i in range(3):  # a batch element gives what it gives alone, bit for bit
        wi, hi = kl_nmf_cuda(v[i:i + 1], w0[:1], h0[:1], 15, matmul_dtype=mode)
        assert torch.equal(wi[0], w[i]) and torch.equal(hi[0], h[i])
    w_p, h_p = kl_nmf_plain(v, w0, h0, 15, matmul_dtype=mode)
    if mode == "float32":
        # 15 fp32 iterations, sums in another order: rtol 1e-4
        torch.testing.assert_close(w, w_p, rtol=1e-4, atol=1e-6 * float(w_p.abs().max()))
        torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-6 * float(h_p.abs().max()))
    else:
        # bf16 roundings can fall the other way where the tensor cores sum
        # in another order: KL within 2 %, W and H each within 1 % of their
        # max (the reference shapes read about 1e-3 after 15 iterations)
        assert abs(_kl(v, w, h) - _kl(v, w_p, h_p)) <= 0.02 * _kl(v, w_p, h_p)
        for g, p in ((w, w_p), (h, h_p)):
            assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())


def test_attribution_winner_is_batch_invariant(cuda):
    """The attribution winner of a batch equals each utterance's alone, bit
    for bit: a batched cuBLAS product may sum in another order than a
    single one, and at the reference shapes that once flipped an argmax at
    a near-tie (separate_batch against separate)."""
    rng = np.random.default_rng(9)
    b, t, f, k = 4, 700, 513, 128
    cre, cim = (torch.as_tensor(rng.standard_normal((b, t, f)), dtype=torch.bfloat16,
                                device=cuda) for _ in range(2))
    w = torch.as_tensor(rng.random((b, f, k)) + 0.05, dtype=torch.float32, device=cuda)
    cos_m, sin_m = gcc.steering_cos_sin(16000.0, f, 1.0, 128)
    tg = torch.as_tensor(rng.integers(0, 128, (b, 3)), device=cuda)
    got = masks.attribution_winner_planes(cre, cim, cos_m, sin_m, tg, w)
    for i in range(b):
        one = masks.attribution_winner_planes(cre[i:i + 1].clone(), cim[i:i + 1].clone(), cos_m,
                                              sin_m, tg[i:i + 1], w[i:i + 1].clone())
        assert torch.equal(got[i:i + 1], one)


def test_nmf_kernel_takes_padded_bf16_v(cuda):
    """A bf16 V wider than F (zero columns), as the front-end of the JAX
    package emits it, gives what the plain version gives."""
    v, w0, h0 = _nmf_problem(cuda, b=1, t=130, f=65, k=8, seed=1)
    vp = torch.zeros((1, 130, 72), device=cuda, dtype=torch.bfloat16)
    vp[..., :65] = v.to(torch.bfloat16)
    w, h = kl_nmf_cuda(vp, w0, h0, 10, matmul_dtype="bfloat16_q")
    w_p, h_p = kl_nmf_plain(vp, w0, h0, 10, matmul_dtype="bfloat16_q")
    assert w.shape == (1, 65, 8) and h.shape == (1, 130, 8)
    assert float((w - w_p).abs().max()) <= 0.05 * float(w_p.abs().max())
    w0_before = w0.clone()
    kl_nmf_cuda(v, w0, h0, 0, matmul_dtype="float32")
    assert torch.equal(w0, w0_before)  # the init is copied, never updated in place


def test_nmf_kernel_rejects_mixed_devices(cuda):
    v, w0, h0 = _nmf_problem(cuda, b=1)
    with pytest.raises(ValueError, match="one CUDA device"):
        kl_nmf_cuda(v, w0.cpu(), h0, 2)


# (window, hop, T, D) of the front-end: ragged T against the 64-frame
# tensor-core tiles and the 64 × 64 SIMT tiles; hop 128 and 64 read the
# frames from the signal, hop 100 and 36 (not multiples of 8) from frame
# rows; F = 513 and 129 leave one bin in their last 64-bin group; D = 37
# (one partial column tile, scalar stores)
FRONTEND_SHAPES = [(1024, 128, 77, 100), (1024, 100, 77, 100), (256, 64, 200, 37),
                   (256, 36, 130, 37), (1024, 512, 61, 64)]


@pytest.mark.parametrize("shape", FRONTEND_SHAPES, ids=lambda s: "win%d-hop%d-t%d-d%d" % s)
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_frontend_kernel_matches_plain(cuda, mode, shape):
    """bf16 on the tensor cores from the basis's rows and fold, float32 on
    the SIMT cores; the kernel needs no hop | window. Reruns are
    bit-identical and every element of a B = 3 batch equals the call of it
    alone, bit for bit."""
    win, hop, t, d = shape
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.standard_normal((3, 2, win + hop * (t - 1))) * 0.1)
                        .astype(np.float32), device=cuda)
    f = win // 2 + 1
    cos_m, sin_m = (torch.as_tensor(m, device=cuda)
                    for m in gcc.steering_cos_sin(16000.0, f, 1.0, d))
    basis = frontend_basis(hann_symmetric(win), device=cuda, matmul_dtype=mode,
                           steering=(cos_m, sin_m))
    args = (x, basis, cos_m, sin_m)
    kw = dict(hop_size=hop, matmul_dtype=mode, plane_dtype=mode)
    before = stft_gcc_frontend_cuda.launches
    got = stft_gcc_frontend_cuda(*args, **kw)
    again = stft_gcc_frontend_cuda(*args, **kw)
    assert stft_gcc_frontend_cuda.launches == before + 2
    want = stft_gcc_frontend_plain(*args, **kw)
    # fp32: 1e-4 of each plane's scale; bf16 planes: one bf16 step (8e-3)
    tol = 1e-4 if mode == "float32" else 8e-3
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        assert float((g.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())
    for i in range(3):  # each utterance's frames sit in the same tiles alone
        one = stft_gcc_frontend_cuda(x[i:i + 1].clone(), basis, cos_m, sin_m, **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[i:i + 1], o)


def test_frontend_kernel_needs_the_basis_rows(cuda):
    """A bf16 call runs the products on the tensor cores from the basis's
    bf16 rows and steering fold; a basis built for float32 has neither, and
    the call raises and launches nothing: nothing falls back to the SIMT
    products."""
    rng = np.random.default_rng(14)
    x = torch.as_tensor((rng.standard_normal((1, 2, 64 + 16 * 9)) * 0.1).astype(np.float32),
                        device=cuda)
    cos_m, sin_m = (torch.as_tensor(m, device=cuda)
                    for m in gcc.steering_cos_sin(16000.0, 33, 1.0, 8))
    before = stft_gcc_frontend_cuda.launches
    for basis in (frontend_basis(hann_symmetric(64), device=cuda),
                  frontend_basis(hann_symmetric(64), device=cuda)[:2]):
        with pytest.raises(ValueError, match="stft_gcc_frontend_cuda: .*rows"):
            stft_gcc_frontend_cuda(x, basis, cos_m, sin_m, hop_size=16, matmul_dtype="bfloat16",
                                   plane_dtype="bfloat16")
    assert stft_gcc_frontend_cuda.launches == before


# (window, hop, T) of the iDFT at the ragged edges of both product tiles
# (SIMT 64 × 64; tensor cores 128 rows × 128 columns, 64-deep slices of
# 2F): window 32 (2F = 34, one 128-wide column tile, hop 2 gives 16
# overlapping frames a sample) and 256 (2F = 258, two column tiles); the
# rows Z·T (840, 1,800; 148, 600 for the Wiener synthesis) no multiple of
# 128
SYNTHESIS_SHAPES = [(32, 2, 70), (256, 32, 150)]
TF_SYNTHESIS_SHAPES = [(32, 8, 37), (32, 2, 37), (256, 64, 150), (1024, 512, 61)]


@pytest.mark.parametrize("shape", SYNTHESIS_SHAPES, ids=lambda s: "win%d-hop%d-t%d" % s)
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_synthesis_kernel_matches_plain(cuda, mode, shape):
    """Planes wider than F, exact-zero mixture bins; bf16 planes and the
    tensor-core iDFT in the bf16 mode. Reruns are bit-identical and every
    batch element equals the call of it alone, bit for bit."""
    win, hop, t = shape
    rng = np.random.default_rng(4)
    b, f, k = 2, win // 2 + 1, 6
    pd = torch.float32 if mode == "float32" else torch.bfloat16
    sre = torch.zeros((b, 2, t, f + 7), device=cuda, dtype=pd)
    sim = torch.zeros_like(sre)
    sre[..., :f] = torch.as_tensor(rng.standard_normal((b, 2, t, f)), dtype=pd, device=cuda)
    sim[..., :f] = torch.as_tensor(rng.standard_normal((b, 2, t, f)), dtype=pd, device=cuda)
    sre[0, 0, 3, 5] = sim[0, 0, 3, 5] = 0.0
    w = torch.as_tensor(rng.random((b, f, k)) + 0.05, dtype=torch.float32, device=cuda)
    h = torch.as_tensor(rng.random((b, 2, t, k)) + 0.01, dtype=torch.float32, device=cuda)
    winner = torch.as_tensor(rng.integers(0, 3, (b, t, k)), dtype=torch.int32, device=cuda)
    basis = synthesis_basis(hann_symmetric(win), 0.25, mode, device=cuda)
    args = (sre, sim, winner, w, h, basis)
    kw = dict(num_targets=3, hop_size=hop, matmul_dtype=mode)
    before = masked_synthesis_cuda.launches
    got = masked_synthesis_cuda(*args, **kw)
    assert torch.equal(got, masked_synthesis_cuda(*args, **kw))
    assert masked_synthesis_cuda.launches == before + 2
    for i in range(b):  # each utterance's rows sit elsewhere in the tiles alone
        one = masked_synthesis_cuda(sre[i:i + 1].clone(), sim[i:i + 1].clone(),
                                    winner[i:i + 1].clone(), w[i:i + 1].clone(),
                                    h[i:i + 1].clone(), basis, **kw)
        assert torch.equal(got[i:i + 1], one)
    want = masked_synthesis_plain(*args, **kw)
    assert got.shape == want.shape == (b, 3, 2, (t - 1) * hop)
    # fp32 sums in another order (1e-4); bf16 operands (1e-2) of the scale
    tol = 1e-4 if mode == "float32" else 1e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_separator_on_card_matches_cpu(cuda):
    """The separator through all three kernels (float32) against the plain
    path on the CPU: same targets, > 25 dB per target."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((3, 16000)).astype(np.float32) * 0.1
    mix = np.stack([s.sum(0), np.roll(s[0], 5) + np.roll(s[1], -7) + np.roll(s[2], 2)])
    cfg = OfflineConfig(dictionary_size=16, num_iterations=10, num_tdoas=64,
                        nmf_matmul_dtype="float32")
    counts = (kl_nmf_cuda.launches, masked_synthesis_cuda.launches,
              stft_gcc_frontend_cuda.launches)
    got = GCCNMFSeparator(cfg, device=cuda).separate(mix)
    assert (kl_nmf_cuda.launches, masked_synthesis_cuda.launches,
            stft_gcc_frontend_cuda.launches) == tuple(c + 1 for c in counts)
    want = GCCNMFSeparator(cfg, device="cpu").separate(mix)
    assert got["target_tdoa_indexes"] == want["target_tdoa_indexes"]
    for ref, est in zip(want["estimates"], got["estimates"]):
        assert 10 * np.log10((ref**2).sum() / ((ref - est) ** 2).sum()) > 25.0
    est, targets = GCCNMFSeparator(cfg, device=cuda).separate_batch(np.stack([mix, mix]))
    assert list(targets[0]) == got["target_tdoa_indexes"]
    np.testing.assert_allclose(est[0], got["estimates"], atol=1e-4)


def _mixture(seed, n=16000):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((3, n)).astype(np.float32) * 0.1
    return np.stack([s.sum(0), np.roll(s[0], 5) + np.roll(s[1], -7) + np.roll(s[2], 2)])


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_separate_batches_on_card_equal_separate_batch(cuda, io_dtype):
    """The pipelined chunks (pinned copies on a copy stream beside the
    compute) give separate_batch's results chunk by chunk, in the turbo mode
    too: float32 bit for bit, int16 as separate_batch's estimates quantized
    to 16 bits, and no yielded array changes while later chunks run."""
    chunks = [np.stack([_mixture(i), _mixture(i + 1), _mixture(i + 2)]) for i in range(3)]
    for md in ("bfloat16_q", "bfloat16_q_simul"):
        cfg = OfflineConfig(dictionary_size=16, num_iterations=10, num_tdoas=64, num_sources=2,
                            nmf_matmul_dtype=md)
        sep = GCCNMFSeparator(cfg, device=cuda)
        got = list(sep.separate_batches(iter(chunks), io_dtype=io_dtype))
        assert len(got) == len(chunks)
        kept = [e.copy() for e, _ in got]
        for chunk, (est, targets), est_kept in zip(chunks, got, kept):
            if io_dtype == "int16":
                chunk = np.clip(chunk * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
            want_est, want_targets = sep.separate_batch(chunk.astype(np.float32))
            np.testing.assert_array_equal(targets, want_targets)
            if io_dtype == "float32":
                np.testing.assert_array_equal(est, want_est)
            else:
                want = np.trunc(np.clip(want_est * 32768.0, -32768, 32767)) / 32768.0
                np.testing.assert_array_equal(est, want.astype(np.float32))
            np.testing.assert_array_equal(est, est_kept)


def test_separate_batch_auto_on_card_matches_cpu(cuda):
    """Source counting on the device: the card's counts and targets are the
    CPU path's (float32 mode, where both compute the same planes), and the
    pad rows are silent."""
    x = np.stack([_mixture(7), _mixture(8)])
    cfg = OfflineConfig(dictionary_size=16, num_iterations=10, num_tdoas=64, num_sources=None,
                        nmf_matmul_dtype="float32")
    est, targets, counts = GCCNMFSeparator(cfg, device=cuda).separate_batch(x, max_sources=5)
    _, want_targets, want_counts = GCCNMFSeparator(cfg, device="cpu").separate_batch(
        x, max_sources=5)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(targets, want_targets)
    for b, c in enumerate(counts):
        assert not est[b, c:].any()


# (B, T, F, K, D) at the ragged edges of both score tiles (SIMT 64 × 64;
# tensor cores 128 rows × 128 atoms, 64-deep slices of 2F): 2F = 34,
# 66, 130 and 1,026 (none a multiple of 64), K = 6 and 72 (not multiples of
# 8) and 130 (two 128-atom tiles), D against chunks of 3, T = 37, 150, 200
# and 70 against 64 and 128 rows
SOFT_MASK_SHAPES = [(2, 37, 17, 6, 10), (3, 150, 33, 6, 13), (3, 200, 65, 72, 9),
                    (3, 70, 513, 130, 7)]


@pytest.mark.parametrize("shape", SOFT_MASK_SHAPES, ids=lambda s: "b%d-t%d-f%d-k%d-d%d" % s)
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_soft_mask_kernel_matches_plain(cuda, mode, shape):
    """Distinct targets and ε per utterance, and a NaN coherence frame,
    whose every score is NaN, so TDOA 0 wins; every batch element equals
    the call of it alone, bit for bit."""
    rng = np.random.default_rng(6)
    b, t, f, k, d = shape
    pd = torch.float32 if mode == "float32" else torch.bfloat16
    cre, cim = (torch.as_tensor(rng.standard_normal((b, t, f)), dtype=pd, device=cuda)
                for _ in range(2))
    cre[1, 5] = float("nan")
    w = torch.as_tensor(rng.random((f, k)) + 0.05, dtype=torch.float32, device=cuda)
    cos_m, sin_m = gcc.steering_cos_sin(16000.0, f, 1.0, d)
    basis = soft_mask_basis(cos_m, sin_m, w, mode)
    tgt, eps = rng.integers(0, d, b), rng.uniform(1.0, 4.0, b)
    args = (cre, cim, basis, torch.as_tensor(tgt, device=cuda),
            torch.as_tensor(eps, dtype=torch.float32, device=cuda), 1.5, 0.1)
    before = soft_mask_cuda.launches
    got, arg = soft_mask_cuda(*args, matmul_dtype=mode, return_argmax=True)
    again, arg2 = soft_mask_cuda(*args, matmul_dtype=mode, return_argmax=True)
    assert soft_mask_cuda.launches == before + 2
    assert torch.equal(got, again) and torch.equal(arg, arg2)
    assert got.shape == (b, t, k) and (arg[1, 5] == 0).all()
    # one TDOA per block here; a ragged split and no split give the same mask
    for chunk in (3, d):
        assert torch.equal(got, soft_mask_cuda(*args, matmul_dtype=mode, tdoa_chunk=chunk))
    for i in range(b):  # each utterance's rows sit elsewhere in the tiles alone
        one = soft_mask_cuda(cre[i:i + 1].clone(), cim[i:i + 1].clone(), basis, int(tgt[i]),
                             float(np.float32(eps[i])), 1.5, 0.1, matmul_dtype=mode)
        assert torch.equal(got[i:i + 1], one)
    want = soft_mask_plain(*args, matmul_dtype=mode)
    # the argmax may flip only at a near-tie: the plain score at the
    # kernel's TDOA within 1e-5 x max|plain maximum| of the plain maximum;
    # everywhere else the masks agree within 2 fp32 ulps; flips stay under
    # 0.1 % (fp32) or 1 % (bf16) of (t, k)
    flipped, gap, scale = argmax_flips(cre, cim, basis, arg, matmul_dtype=mode)
    assert gap <= 1e-5 * scale
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulps[~flipped].max()) <= 2
    assert float(flipped.float().mean()) <= (1e-3 if mode == "float32" else 1e-2)


def test_soft_mask_kernel_needs_its_modes_basis(cuda):
    """bf16 runs on the tensor cores from the basis's bf16 fold, float32 on
    the SIMT cores from an fp32 one; a basis of the other mode raises, and
    nothing falls back to another kernel or to the plain version."""
    rng = np.random.default_rng(10)
    cre, cim = (torch.as_tensor(rng.standard_normal((1, 20, 17)), dtype=torch.float32,
                                device=cuda) for _ in range(2))
    w = torch.as_tensor(rng.random((17, 6)) + 0.05, dtype=torch.float32, device=cuda)
    cos_m, sin_m = gcc.steering_cos_sin(16000.0, 17, 1.0, 8)
    before = soft_mask_cuda.launches
    for basis_mode, mode in (("float32", "bfloat16"), ("bfloat16", "float32")):
        with pytest.raises(ValueError, match="soft_mask_cuda"):
            soft_mask_cuda(cre, cim, soft_mask_basis(cos_m, sin_m, w, basis_mode), 3, 2.0, 2.0,
                           0.0, matmul_dtype=mode)
    assert soft_mask_cuda.launches == before


@pytest.mark.parametrize("shape", TF_SYNTHESIS_SHAPES, ids=lambda s: "win%d-hop%d-t%d" % s)
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_tf_synthesis_kernel_matches_plain(cuda, mode, shape):
    """K = 6, B = 2; bf16 planes and the tensor-core iDFT in the bf16 mode.
    Reruns are bit-identical and every batch element equals the call of it
    alone, bit for bit."""
    win, hop, t = shape
    rng = np.random.default_rng(7)
    b, f, k = 2, win // 2 + 1, 6
    pd = torch.float32 if mode == "float32" else torch.bfloat16
    sre, sim = (torch.as_tensor(rng.standard_normal((b, 2, t, f)), dtype=pd, device=cuda)
                for _ in range(2))
    h_mask = torch.as_tensor(rng.random((b, t, k)), dtype=torch.float32, device=cuda)
    w = torch.as_tensor(rng.random((f, k)) + 1e-3, dtype=torch.float32, device=cuda)
    basis = tf_synthesis_basis(w, hann_symmetric(win), 0.5, mode)
    kw = dict(hop_size=hop, matmul_dtype=mode)
    before = tf_synthesis_cuda.launches
    got = tf_synthesis_cuda(sre, sim, h_mask, basis, **kw)
    assert torch.equal(got, tf_synthesis_cuda(sre, sim, h_mask, basis, **kw))
    assert tf_synthesis_cuda.launches == before + 2
    for i in range(b):
        one = tf_synthesis_cuda(sre[i:i + 1].clone(), sim[i:i + 1].clone(),
                                h_mask[i:i + 1].clone(), basis, **kw)
        assert torch.equal(got[i:i + 1], one)
    want = tf_synthesis_plain(sre, sim, h_mask, basis, **kw)
    assert got.shape == want.shape == (b, 2, (t - 1) * hop)
    # fp32 sums in another order (1e-4); bf16 operands (1e-2) of the scale
    tol = 1e-4 if mode == "float32" else 1e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_synthesis_kernels_need_the_basis_rows(cuda):
    """A bf16 call runs the iDFT on the tensor cores from the basis's bf16
    rows; a basis built for float32 has none, and the call raises and
    launches nothing: nothing falls back to the SIMT iDFT."""
    rng = np.random.default_rng(12)
    b, t, f, k = 1, 20, 17, 6
    sre, sim = (torch.as_tensor(rng.standard_normal((b, 2, t, f)), dtype=torch.bfloat16,
                                device=cuda) for _ in range(2))
    w = torch.as_tensor(rng.random((f, k)) + 0.05, dtype=torch.float32, device=cuda)
    h = torch.as_tensor(rng.random((b, 2, t, k)), dtype=torch.float32, device=cuda)
    winner = torch.zeros((b, t, k), dtype=torch.int32, device=cuda)
    window = hann_symmetric(32)
    before = (masked_synthesis_cuda.launches, tf_synthesis_cuda.launches)
    with pytest.raises(ValueError, match="masked_synthesis_cuda: .*rows"):
        masked_synthesis_cuda(sre, sim, winner, w[None], h,
                              synthesis_basis(window, 0.25, "float32", device=cuda),
                              num_targets=2, hop_size=8, matmul_dtype="bfloat16")
    with pytest.raises(ValueError, match="tf_synthesis_cuda: .*rows"):
        tf_synthesis_cuda(sre, sim, h[:, 0], tf_synthesis_basis(w, window, 0.25, "float32"),
                          hop_size=8, matmul_dtype="bfloat16")
    assert (masked_synthesis_cuda.launches, tf_synthesis_cuda.launches) == before


def test_enhancer_on_card_matches_cpu(cuda):
    """The enhancer through the front-end, soft-mask and Wiener-synthesis
    kernels (float32) against the plain path on the CPU: same target,
    > 25 dB per channel; with H updates both tail kernels stay out, as the
    JAX enhancer leaves its fused kernels there."""
    rng = np.random.default_rng(8)
    s = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    mix = np.stack([s.sum(0), np.roll(s[0], 3) + np.roll(s[1], -5)])
    w = rng.random((513, 16)).astype(np.float32) + 1e-3
    cfg = OfflineConfig(mic_separation_m=0.1, num_tdoas=32, dictionary_size=16,
                        nmf_matmul_dtype="float32")
    for nh in (0, 2):
        counts = (stft_gcc_frontend_cuda.launches, soft_mask_cuda.launches,
                  tf_synthesis_cuda.launches)
        got = GCCNMFEnhancer(w, cfg, num_h_updates=nh, device=cuda).enhance(mix)
        assert (stft_gcc_frontend_cuda.launches, soft_mask_cuda.launches,
                tf_synthesis_cuda.launches) == (counts[0] + 1, counts[1] + (nh == 0),
                                                counts[2] + (nh == 0))
        want = GCCNMFEnhancer(w, cfg, num_h_updates=nh, device="cpu").enhance(mix)
        assert int(got["target_tdoa_index"]) == int(want["target_tdoa_index"])
        for ref, est in zip(want["enhanced"], got["enhanced"]):
            assert 10 * np.log10((ref**2).sum() / ((ref - est) ** 2).sum()) > 25.0
    enh = GCCNMFEnhancer(w, cfg, device=cuda)
    batch = enh.enhance(np.stack([mix, mix[::-1].copy()]))
    one = enh.enhance(mix)
    assert int(batch["target_tdoa_index"][0]) == int(one["target_tdoa_index"])
    np.testing.assert_allclose(batch["enhanced"][0], one["enhanced"],
                               atol=1e-5 * np.abs(one["enhanced"]).max())


def test_enhancer_h_updates_take_the_fp32_argmax(cuda, monkeypatch):
    """bf16 mode with H updates: the coefficient mask the enhancer builds is
    ``soft_tdoa_coefficient_mask(argmax_tdoa(...))`` on the front-end
    kernel's bf16 planes and the fp32 fold, as in JAX's XLA tail, at β = 0
    too (where the soft-mask kernel would pin distance 0 to 1)."""
    rng = np.random.default_rng(13)
    s = rng.standard_normal((2, 16000)).astype(np.float32) * 0.1
    mix = np.stack([s.sum(0), np.roll(s[0], 3) + np.roll(s[1], -5)])
    w = rng.random((513, 16)).astype(np.float32) + 1e-3
    cfg = OfflineConfig(mic_separation_m=0.1, num_tdoas=32, dictionary_size=16)
    seen = []
    literal = masks.soft_tdoa_coefficient_mask
    monkeypatch.setattr(masks, "soft_tdoa_coefficient_mask",
                        lambda *a: seen.append(literal(*a)) or seen[-1])
    enh = GCCNMFEnhancer(w, cfg, target_beta=0.0, num_h_updates=2, device=cuda)
    counts = (soft_mask_cuda.launches, tf_synthesis_cuda.launches)
    got = enh.enhance(mix)
    assert (soft_mask_cuda.launches, tf_synthesis_cuda.launches) == counts
    assert np.isfinite(got["enhanced"]).all() and len(seen) == 1
    x = torch.as_tensor(mix[None], device=cuda)
    _, _, _, cre, cim, ang = stft_gcc_frontend_cuda(
        x, enh._dft_basis, enh._cos, enh._sin, hop_size=cfg.hop_size, matmul_dtype="bfloat16",
        plane_dtype="bfloat16")
    assert cre.dtype == torch.bfloat16
    cos_w, sin_w = masks.fold_steering_dictionary(enh._cos, enh._sin, enh.w)
    arg = masks.argmax_tdoa(cre[..., :513], cim[..., :513], cos_w, sin_w, 32)
    target = torch.argmax(gcc.mean_angular_spectrum(ang), dim=-1)
    assert int(target[0]) == int(got["target_tdoa_index"])
    want = literal(arg, target.to(torch.float32)[:, None, None], 5.0, 0.0, 0.0)
    assert torch.equal(seen[0], want)
    assert float(want.max()) < 1.0  # 0**0 = 1: exp(−1) at distance 0 too


# ---- the streaming engine and the server: a captured CUDA graph per step --

STREAM_CONFIGS = {
    "default": StreamConfig(),
    "delay-fifo-h-updates": StreamConfig(extra_delay_blocks=1, num_h_updates=2),
    "low-latency-boxcar": StreamConfig(hop_size=128, block_size=128, target_mode=0,
                                       analysis_window="asymmetric", synthesis_length=256),
}


def _stream_problem(cfg, batch, blocks, k=32, seed=0):
    """A dictionary and (batch, 2, n) mixtures of one delayed noise source
    and a little independent noise per channel."""
    rng = np.random.default_rng(seed)
    w = rng.random((cfg.num_freq, k)).astype(np.float32) + 1e-3
    s = rng.standard_normal((batch, blocks * cfg.block_size)).astype(np.float32) * 0.1
    noise = rng.standard_normal((batch, 2, s.shape[-1])).astype(np.float32) * 0.01
    mix = np.stack([s, np.roll(s, 3, axis=-1)], axis=1) + noise
    return w, mix.astype(np.float32)


@pytest.mark.parametrize("name", list(STREAM_CONFIGS))
def test_stream_graph_replay_matches_eager(cuda, name):
    """The captured step equals the eager step on the card block by block
    (output and every state leaf), through a parameter change that
    re-captures nothing."""
    cfg = STREAM_CONFIGS[name]
    w, mix = _stream_problem(cfg, 3, 12)
    proc = RTGCCNMFProcessor(w, cfg, device=cuda)
    blocks = torch.as_tensor(proc.blocks_from_signal(mix), device=cuda)
    params = [StreamParams.default(localization_window=4, device=cuda),
              StreamParams.default(target_epsilon=2.0, target_beta=1.0, noise_floor=0.1,
                                   localization_enabled=False, target_tdoa_index=20.0,
                                   device=cuda)]
    eager, graph = proc.init_state(3), proc.init_state(3)
    for i in range(blocks.shape[0]):
        p = params[i >= 6]
        eager, want, tel_e = proc.eager_step(eager, blocks[i], p)
        graph, got, tel_g = proc.step(graph, blocks[i], p)
        scale = max(float(want.abs().max()), 1e-9)
        assert float((got - want).abs().max()) <= 1e-6 * scale, f"block {i}"
        for a, b in zip(graph, eager):
            assert a.shape == b.shape
            if b.numel():
                assert float((a.double() - b.double()).abs().max()) <= 1e-6 * max(
                    float(b.abs().max()), 1.0)
        assert torch.equal(graph.target_idx, eager.target_idx)
        assert torch.equal(tel_g["coefficient_mask"], tel_e["coefficient_mask"])
    assert list(proc._graphs) == [3]  # one graph: the parameter change re-captured nothing


def test_stream_on_card_matches_cpu(cuda):
    """``enhance_signal`` on the card against the port's CPU path: the
    streaming oracle's bars (SNR > 25 dB, > 0.93 of samples within 3e-4 x
    max) and the coefficient masks agreeing on > 0.995."""
    cfg = StreamConfig(num_h_updates=2)
    w, mix = _stream_problem(cfg, 1, 30, k=64, seed=1)
    params = dict(target_tdoa_index=30.0, localization_enabled=False)
    want = RTGCCNMFProcessor(w, cfg, device="cpu").enhance_signal(
        mix, StreamParams.default(**params, device="cpu"))
    got = RTGCCNMFProcessor(w, cfg, device=cuda).enhance_signal(
        mix, StreamParams.default(**params, device=cuda))
    err = got - want
    assert 10 * np.log10((want ** 2).sum() / (err ** 2).sum()) > 25.0
    assert (np.abs(err) < 3e-4 * np.abs(want).max()).mean() > 0.93
    masks_ = []
    for dev in ("cpu", cuda):
        proc = RTGCCNMFProcessor(w, cfg, device=dev)
        blocks = proc.blocks_from_signal(mix)
        _, (_, tel) = proc.scan_blocks(proc.init_state(1), blocks,
                                       StreamParams.default(**params, device=dev), True)
        masks_.append(tel["coefficient_mask"].cpu())
    assert float((masks_[0] == masks_[1]).float().mean()) > 0.995


def test_served_slot_equals_stream_alone(cuda):
    """Every one of 64 served streams (pipeline depth 2, async fetch, other
    settings per stream) gives what its stream gives through a batch-1
    processor, at JAX's 1e-5: the argmax inputs are batch-invariant."""
    cfg = StreamConfig()
    n_streams, ticks = 64, 10
    w, mix = _stream_problem(cfg, n_streams, ticks, k=64, seed=2)
    server = StreamServer(w, cfg, max_streams=n_streams, pipeline_depth=2, async_fetch=True,
                          device=cuda)
    settings = [StreamSettings(target_tdoa_index=float(8 + i % 48),
                               localization_enabled=bool(i % 2),
                               target_epsilon=3.0 + i % 4) for i in range(n_streams)]
    sids = [server.open_stream(s) for s in settings]
    blocks = RTGCCNMFProcessor(w, cfg, device="cpu").blocks_from_signal(mix)
    got = {sid: [] for sid in sids}
    for t in range(ticks):
        for sid, out in server.process({sid: blocks[t, i] for i, sid in enumerate(sids)}).items():
            got[sid].append(out)
    for tail in server.flush():
        for sid, out in tail.items():
            got[sid].append(out)
    server.close()
    proc = RTGCCNMFProcessor(w, cfg, device=cuda)
    for i, sid in enumerate(sids):
        s = settings[i]
        params = StreamParams.default(
            target_tdoa_index=s.target_tdoa_index, target_epsilon=s.target_epsilon,
            localization_enabled=s.localization_enabled, device=cuda)
        state = proc.init_state(1)
        for t in range(ticks):
            state, solo, _ = proc.step(state, blocks[t, i:i + 1], params)
            np.testing.assert_allclose(got[sid][t], solo[0].cpu().numpy(), atol=1e-5)


def test_int16_wire_on_card(cuda):
    """The int16 wire converts inside the graph: it equals the float32
    server up to output quantization on int16-born input; a NaN tenant's
    output is 0 (JAX's rule on the CPU) and its co-tenant is bit-exact."""
    cfg = StreamConfig()
    w, mix = _stream_problem(cfg, 2, 6, k=16, seed=3)
    blocks = RTGCCNMFProcessor(w, cfg, device="cpu").blocks_from_signal(mix)
    blocks = (np.round(np.clip(blocks, -1, 0.999) * 32768.0) / 32768.0).astype(np.float32)
    srv_f = StreamServer(w, cfg, max_streams=2, device=cuda)
    srv_i = StreamServer(w, cfg, max_streams=2, wire_dtype="int16", device=cuda)
    srv_nan = StreamServer(w, cfg, max_streams=2, wire_dtype="int16", device=cuda)
    sf, si = srv_f.open_stream(), srv_i.open_stream()
    good, bad = srv_nan.open_stream(), srv_nan.open_stream()
    poison = np.full(blocks.shape[2:], np.nan, np.float32)
    for t in range(blocks.shape[0]):
        out_f = srv_f.process({sf: blocks[t, 0]})[sf]
        out_i = srv_i.process({si: blocks[t, 0]})[si]
        assert out_i.dtype == np.float32
        np.testing.assert_allclose(out_i, out_f, atol=2.0**-15 + 1e-7)
        out = srv_nan.process({good: blocks[t, 0], bad: poison})
        assert np.array_equal(out[good], out_i)
        assert np.array_equal(out[bad], np.zeros_like(out[bad]))
    x = torch.tensor([np.nan, np.inf, -np.inf, 0.7, -0.99999, 1.0], device=cuda)
    assert float_to_pcm(x).tolist() == [0, 32767, -32768, 22937, -32767, 32767]


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_sharded_server_equals_unsharded_on_card(cuda, wire):
    """``StreamServer(mesh=local_mesh(1))`` and two shards on this card
    (each its own graph): every stream within 1e-5 of the unsharded server
    (pipelined, async fetch), the same telemetry; the default two-card
    mesh raises on a one-card machine. 64 streams over 40 ticks: load
    enough to show a race between two graphs of one card replaying at
    once (they share cuFFT plans and their capture's cuBLAS workspace)."""
    cfg = StreamConfig()
    n_streams, ticks = 64, 40
    w, mix = _stream_problem(cfg, n_streams, ticks, k=16, seed=7)
    blocks = RTGCCNMFProcessor(w, cfg, device="cpu").blocks_from_signal(mix)
    if wire == "int16":
        blocks = (np.round(np.clip(blocks, -1, 0.999) * 32768.0) / 32768.0).astype(np.float32)
    settings = [StreamSettings(target_tdoa_index=float(8 + 5 * i),
                               localization_enabled=bool(i % 2)) for i in range(n_streams)]
    runs = []
    for mesh in (None, local_mesh(1), local_mesh(2, devices=["cuda:0", "cuda:0"])):
        server = StreamServer(w, cfg, max_streams=n_streams, pipeline_depth=2, async_fetch=True,
                              wire_dtype=wire, mesh=mesh)
        sids = [server.open_stream(s) for s in settings]
        got = {sid: [] for sid in sids}
        for t in range(ticks):
            for sid, out in server.process({sid: blocks[t, i]
                                            for i, sid in enumerate(sids)}).items():
                got[sid].append(out)
        tel = server.telemetry
        for tail in server.flush():
            for sid, out in tail.items():
                got[sid].append(out)
        server.close()
        runs.append(([np.concatenate(got[sid], axis=-1) for sid in sids],
                     [tel[sid]["target_tdoa_index"] for sid in sids]))
    for outs, targets in runs[1:]:
        assert targets == runs[0][1]
        for a, b in zip(outs, runs[0][0]):
            np.testing.assert_allclose(a, b, atol=1e-5)
    if torch.cuda.device_count() == 1:
        with pytest.raises(ValueError, match="exceeds 1 devices"):
            local_mesh(2)


def test_conv_stft_on_card_matches_fft(cuda):
    """``method="conv"`` (cuDNN, TF32 off) against ``fft`` on the card, at
    the JAX suite's bars (tests/test_stft.py:49-80)."""
    rng = np.random.default_rng(8)
    y = torch.as_tensor(rng.standard_normal((2, 16000)).astype(np.float32) * 0.1, device=cuda)
    win = hann_symmetric(1024)
    spec = {m: stft_ops.stft(y, win, 128, conjugate=True, method=m) for m in ("fft", "conv")}
    scale = float(spec["fft"].abs().max())
    assert float((spec["conv"] - spec["fft"]).abs().max()) <= 2e-4 * scale
    inv = {m: stft_ops.istft(spec["fft"], win, 128, conjugate=True, center_trim=True, method=m)
           for m in ("fft", "conv")}
    assert float((inv["conv"] - inv["fft"]).abs().max()) <= 5e-5 * float(inv["fft"].abs().max())
    assert not torch.backends.cudnn.allow_tf32


def test_default_stream_objects_live_on_the_card(cuda):
    """``device=None`` puts every tensor of the processor, its state, the
    default parameters and the server's state on the card."""
    cfg = StreamConfig()
    w, _ = _stream_problem(cfg, 1, 1, k=8)
    proc = RTGCCNMFProcessor(w, cfg)
    tensors = [v for v in vars(proc).values() if isinstance(v, torch.Tensor)]
    tensors += [t for v in vars(proc).values() if isinstance(v, tuple)
                for t in v if isinstance(t, torch.Tensor)]
    tensors += list(proc.init_state(2)) + list(StreamParams.default())
    server = StreamServer(w, cfg, max_streams=2)
    tensors += list(server._shards[0].state)
    assert len(tensors) > 20
    assert all(t.device.type == "cuda" for t in tensors)


# ---- the realtime app on the captured step ------------------------------


def _app_files(tmp_path, blocks=40, k=16, seed=6):
    """A seeded stereo WAV of ``blocks`` default blocks and a (513, k)
    dictionary file."""
    cfg = StreamConfig()
    w, mix = _stream_problem(cfg, 1, blocks, k=k, seed=seed)
    path, dic = str(tmp_path / "mix.wav"), str(tmp_path / f"W_{k}.npy")
    wav.write_wav(mix[0], path, cfg.sample_rate)
    np.save(dic, w)
    return path, dic


def _rt_app(path, dic, depth=0, device=None):
    from gccnmf_torch.realtime import RealtimeGCCNMF

    return RealtimeGCCNMF(path, config=GCCNMFConfig(dictionary_file=dic),
                          pipeline_depth=depth, device=device)


def test_app_pipelined_file_identical_on_card(cuda, tmp_path):
    """Each queued output has its own pinned buffer: depth 2 writes the
    depth-0 file byte for byte, and the card's file meets the streaming
    oracle's bars against the CPU app's."""
    path, dic = _app_files(tmp_path)
    files = {}
    for name, depth, dev in (("d0", 0, None), ("d2", 2, None), ("cpu", 0, "cpu")):
        out = str(tmp_path / f"{name}.wav")
        stats = _rt_app(path, dic, depth, dev).run(output_path=out)
        assert stats["blocks"] == 40
        files[name] = out
    raw = [open(files[k], "rb").read() for k in ("d0", "d2")]
    assert raw[0] == raw[1]
    got, want = wav.read_wav(files["d0"])[0], wav.read_wav(files["cpu"])[0]
    err = got - want
    assert 10 * np.log10((want ** 2).sum() / (err ** 2).sum()) > 25.0
    assert (np.abs(err) < 3e-4 * np.abs(want).max()).mean() > 0.93


def test_app_histories_equal_the_eager_telemetry_on_card(cuda, tmp_path):
    """Each block's telemetry is copied out of the graph's own tensors
    before the next replay overwrites them: after a run the histories equal
    the eager step's telemetry block by block (1e-6 x max, targets
    exactly)."""
    from gccnmf_torch.realtime import FilePlayerSource

    path, dic = _app_files(tmp_path)
    app = _rt_app(path, dic)
    app.run()
    proc = RTGCCNMFProcessor(np.load(dic), StreamConfig.from_app_config(app.config),
                             device=cuda)
    params = StreamParams(*(p.to(cuda) for p in app.params))
    state, tels = proc.init_state(1), []
    for block in FilePlayerSource(path, 512).blocks():
        state, _, tel = proc.eager_step(state, torch.as_tensor(block[None], device=cuda), params)
        tels.append({k: v.cpu().numpy() for k, v in tel.items()})
    h = app.histories
    for key, tkey in (("gcc_phat", "gcc_phat"), ("input_spectrogram", "input_mag"),
                      ("output_spectrogram", "output_mag"),
                      ("coefficient_mask", "coefficient_mask")):
        want = np.concatenate([t[tkey][0] for t in tels])
        got = h[key].get()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=1e-6 * max(np.abs(want).max(), 1e-9),
                                   err_msg=key)
    np.testing.assert_array_equal(h["tdoa"].get(),
                                  np.concatenate([t["target_tdoa_index"] for t in tels]))
    assert all(p.device.type == "cpu" for p in app.params)


def test_app_setters_and_reads_during_rebuild_captures(cuda, tmp_path):
    """A second thread calls every setter and reads ``histories``,
    ``params`` and ``peek_dictionary`` while the audio thread captures the
    new engines' graphs: no exception, finite outputs, host values only,
    and device memory flat across rebuilds."""
    import threading

    path, dic = _app_files(tmp_path, k=16)
    app = _rt_app(path, dic)
    block = np.zeros((2, 512), np.float32) + 0.01
    app.process_block(block)
    errors, stop = [], threading.Event()

    def control():
        try:
            while not stop.is_set():
                app.set_target_window(target_tdoa_index=20.0)
                h = app.histories
                assert isinstance(h["gcc_phat"].get(), np.ndarray)
                w = app.peek_dictionary()
                assert w is None or isinstance(w, np.ndarray)
                assert all(p.device.type == "cpu" for p in app.params)
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    t = threading.Thread(target=control)
    t.start()
    try:
        memory = []
        for i in range(12):
            app.set_mic_separation(0.1 + 0.01 * i)
            if i in (3, 6):  # H updates on, then off again
                app.set_num_h_updates(2 if i == 3 else 0)
            for _ in range(3):
                out = app.process_block(block)
                assert out.shape == (2, 512) and np.isfinite(out).all()
            memory.append(torch.cuda.memory_allocated(cuda))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errors, errors
    assert len(app.rebuild_ms) == 13
    assert memory[-1] <= memory[1], memory


WRAPPERS = (stft_gcc_frontend_cuda, kl_nmf_cuda, masked_synthesis_cuda, soft_mask_cuda,
            tf_synthesis_cuda)


def _launches():
    return [fn.launches for fn in WRAPPERS]


def _corpus(t=700, f=513, seed=4):
    rng = np.random.default_rng(seed)
    v = (rng.random((t, 6)) + 0.05) @ (rng.random((f, 6)) + 0.05).T + 0.01
    return v.astype(np.float32)


def test_pretrain_on_card_matches_plain(cuda, tmp_path):
    """pretrain_dictionary on the card runs JAX's unguarded plain updates
    and launches no kernel, trained or from the cache; W within rtol 1e-4
    of the plain kl_nmf on the card after 15 iterations."""
    corpus = _corpus()
    cache = str(tmp_path / "cache")
    before = _launches()
    got = pretrain.pretrain_dictionary(corpus, 24, num_iterations=15, cache_dir=cache,
                                       device=cuda)
    again = pretrain.pretrain_dictionary(corpus, 24, num_iterations=15, cache_dir=cache,
                                         device=cuda)
    assert _launches() == before
    np.testing.assert_array_equal(got, again)
    w0, h0 = nmf_init_numpy(513, 24, corpus.shape[0])
    want, _ = kl_nmf(*(torch.as_tensor(x, device=cuda) for x in (corpus, w0, h0)), 15)
    torch.testing.assert_close(torch.as_tensor(got, device=cuda), want, rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))


def test_checkpointed_chunks_equal_one_plain_call(cuda, tmp_path):
    """Chunks of 7, and a run resumed from its 14-iteration checkpoint,
    equal one 20-iteration plain kl_nmf call on the card bit for bit, with
    no kernel launch: each chunk restarts the same updates from the saved
    W and H, which carry all the state."""
    v = torch.as_tensor(_corpus(t=400, f=65), device=cuda)
    w0, h0 = (torch.as_tensor(x, device=cuda) for x in nmf_init_numpy(65, 16, 400))
    w_one, h_one = kl_nmf(v, w0, h0, 20)
    before = _launches()
    w_ck, h_ck = checkpoint.kl_nmf_checkpointed(v, w0, h0, 20, str(tmp_path / "a"),
                                                checkpoint_every=7, device=cuda)
    assert torch.equal(w_ck, w_one) and torch.equal(h_ck, h_one)
    checkpoint.kl_nmf_checkpointed(v, w0, h0, 14, str(tmp_path / "b"), checkpoint_every=7,
                                   device=cuda)
    w_re, h_re = checkpoint.kl_nmf_checkpointed(v, w0, h0, 20, str(tmp_path / "b"),
                                                checkpoint_every=7, device=cuda)
    assert torch.equal(w_re, w_one) and torch.equal(h_re, h_one)
    assert _launches() == before


def test_corpus_nmf_on_a_silent_frame_follows_jax(cuda, tmp_path):
    """A corpus frame of digital silence: on the card, as on the CPU and in
    JAX (unguarded updates, 0/0), W turns NaN. Without that frame the card
    equals the CPU (rtol 1e-4)."""
    corpus = _corpus(t=300, f=65)
    corpus[7] = 0.0
    w0, h0 = nmf_init_numpy(65, 8, 300)
    before = _launches()
    w, _ = pretrain.corpus_nmf(*(torch.as_tensor(x, device=cuda) for x in (corpus, w0, h0)), 5)
    assert bool(torch.isnan(w).all())
    w_cpu, _ = pretrain.corpus_nmf(*(torch.as_tensor(x) for x in (corpus, w0, h0)), 5)
    assert bool(torch.isnan(w_cpu).all())
    clean = np.delete(corpus, 7, axis=0)
    w_c, _ = pretrain.corpus_nmf(*(torch.as_tensor(x, device=cuda) for x in
                                   (clean, w0, np.delete(h0, 7, axis=0))), 5)
    w_p, _ = pretrain.corpus_nmf(*(torch.as_tensor(x) for x in
                                   (clean, w0, np.delete(h0, 7, axis=0))), 5)
    assert bool(torch.isfinite(w_c).all())
    torch.testing.assert_close(w_c.cpu(), w_p, rtol=1e-4, atol=1e-6 * float(w_p.abs().max()))
    assert _launches() == before


@pytest.mark.parametrize("smoothing", ["sliding", "exponential"])
def test_online_enhancer_batch_invariant_and_matches_cpu(cuda, smoothing):
    """Each batch element of the online enhancer on the card equals the
    element alone (1e-5 x max) and the CPU's run (> 25 dB, targets equal on
    >= 99 % of frames); no kernel launches."""
    cfg = StreamConfig()
    w, mix = _stream_problem(cfg, 3, 40, k=24, seed=6)
    ocfg = OnlineConfig(smoothing=smoothing, num_h_updates=2)
    before = _launches()
    enh = OnlineGCCNMFEnhancer(w, ocfg, device=cuda)
    batch = enh.enhance(mix)
    assert _launches() == before
    for i in range(3):
        one = enh.enhance(mix[i])
        np.testing.assert_allclose(batch["enhanced"][i], one["enhanced"], rtol=0,
                                   atol=1e-5 * np.abs(one["enhanced"]).max())
        np.testing.assert_array_equal(batch["target_tdoa_index"][i], one["target_tdoa_index"])
    cpu = OnlineGCCNMFEnhancer(w, ocfg, device="cpu").enhance(mix)
    assert (cpu["target_tdoa_index"] == batch["target_tdoa_index"]).mean() >= 0.99
    n_out = batch["enhanced"].shape[-1]
    for ref, est in zip(cpu["enhanced"].reshape(-1, n_out), batch["enhanced"].reshape(-1, n_out)):
        assert 10 * np.log10((ref**2).sum() / ((ref - est) ** 2).sum()) > 25.0


def test_enhance_command_offline_at_hop_512(cuda, tmp_path, capsys):
    """``enhance --mode offline`` on the card runs the front-end, soft-mask
    and Wiener-synthesis kernels at the command's window 1024 / hop 512,
    within 25 dB of the same command on the CPU; each of the three, fed
    the command's enhancer's own operands on the same WAV, meets its plain
    version at the per-kernel bars of the tests above."""
    cfg = StreamConfig()
    w, mix = _stream_problem(cfg, 1, 60, k=32, seed=9)
    dic = str(tmp_path / "W.npy")
    np.save(dic, w)
    outs = {}
    for device in ("cuda", "cpu"):
        path = str(tmp_path / f"{device}.wav")
        wav.write_wav(mix[0], path, 16000)
        before = _launches()
        assert cli.main(["enhance", path, "--mode", "offline", "--dictionary-file", dic,
                         "--device", device]) == 0
        ran = [a - b for a, b in zip(_launches(), before)]
        assert ran == ([1, 0, 0, 1, 1] if device == "cuda" else [0] * 5)
        outs[device] = wav.read_wav(json.loads(capsys.readouterr().out)["output"])[0]
    for ref, est in zip(outs["cpu"], outs["cuda"]):
        assert 10 * np.log10((ref**2).sum() / ((ref - est) ** 2).sum()) > 25.0

    enh = cli._make_enhancer("offline", GCCNMFConfig(), w, 16000, cuda)
    x = torch.as_tensor(wav.read_wav(str(tmp_path / "cuda.wav"))[0][None], device=cuda)
    kw = dict(hop_size=512, matmul_dtype="bfloat16")
    fe_args = (x, enh._dft_basis, enh._cos, enh._sin)
    planes = stft_gcc_frontend_cuda(*fe_args, plane_dtype="bfloat16", **kw)
    for g, p in zip(planes, stft_gcc_frontend_plain(*fe_args, plane_dtype="bfloat16", **kw)):
        assert float((g.float() - p.float()).abs().max()) <= 8e-3 * float(p.float().abs().max())
    sre, sim, _, cre, cim, ang = planes
    tgt = torch.argmax(gcc.mean_angular_spectrum(ang), dim=-1)
    margs = (cre, cim, enh._mask_basis, tgt, enh.target_epsilon, enh.target_beta,
             enh.noise_floor)
    got, arg = soft_mask_cuda(*margs, matmul_dtype="bfloat16", return_argmax=True)
    want = soft_mask_plain(*margs, matmul_dtype="bfloat16")
    flipped, gap, scale = argmax_flips(cre, cim, enh._mask_basis, arg, matmul_dtype="bfloat16")
    assert gap <= 1e-5 * scale
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulps[~flipped].max()) <= 2 and float(flipped.float().mean()) <= 1e-2
    syn = tf_synthesis_cuda(sre, sim, got, enh._tf_basis, **kw)
    syn_plain = tf_synthesis_plain(sre, sim, got, enh._tf_basis, **kw)
    assert float((syn - syn_plain).abs().max()) <= 1e-2 * float(syn_plain.abs().max())


def _long_mix(tmp_path, seconds=12, silence=None, seed=9):
    """A 16-bit WAV of three white-noise sources 8, -11 and 3 samples apart
    between the mics (chip_smoke's mixture), optionally with a silent span
    ``(start, stop)`` in samples."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((3, 16000 * seconds)).astype(np.float32) * 0.1
    mix = np.stack([src.sum(0), sum(np.roll(s, d) for s, d in zip(src, (8, -11, 3)))])
    if silence is not None:
        mix[:, silence[0]:silence[1]] = 0.0
    path = str(tmp_path / "long_mix.wav")
    wav.write_wav(mix, path, 16000)
    return path


def _snr_db(ref, est):
    return float(10 * np.log10((ref ** 2).sum() / max(((ref - est) ** 2).sum(), 1e-30)))


def test_streamed_on_card_matches_cpu(cuda, tmp_path):
    """separate_streamed of 12 s at full config (bf16 planes, chunks of 1024
    frames, the last ragged) on the card: the CPU run's targets, >= 40 dB
    per output against it, and no kernel launched."""
    path = _long_mix(tmp_path)
    runs = {}
    before = _launches()
    for dev in ("cuda", "cpu"):
        runs[dev] = LongAudioSeparator(OfflineConfig(), device=dev, chunk_frames=1024)\
            .separate_streamed(path, output_prefix=str(tmp_path / dev))
    assert _launches() == before
    assert runs["cuda"]["target_tdoa_indexes"] == runs["cpu"]["target_tdoa_indexes"]
    assert runs["cuda"]["samples_written"] == runs["cpu"]["samples_written"]
    for p, q in zip(runs["cuda"]["paths"], runs["cpu"]["paths"], strict=True):
        got, want = wav.read_wav(p)[0], wav.read_wav(q)[0]
        assert np.isfinite(got).all() and got.shape == want.shape
        assert min(_snr_db(r, e) for r, e in zip(want, got)) >= 40.0


def test_streamed_device_init_is_deterministic_on_card(cuda, tmp_path):
    """nmf_init='device' draws H0 on the card from a generator seeded with
    0: two calls write the same files."""
    path = _long_mix(tmp_path, seconds=6)
    sep = LongAudioSeparator(OfflineConfig(), device=cuda, chunk_frames=256, nmf_init="device")
    a = sep.separate_streamed(path, output_prefix=str(tmp_path / "a"))
    b = sep.separate_streamed(path, output_prefix=str(tmp_path / "b"))
    assert a["target_tdoa_indexes"] == b["target_tdoa_indexes"]
    for p, q in zip(a["paths"], b["paths"], strict=True):
        x = wav.read_wav(p)[0]
        assert np.isfinite(x).all() and np.abs(x).max() > 0
        np.testing.assert_array_equal(x, wav.read_wav(q)[0])


def test_streamed_silent_span_finite_on_card(cuda, tmp_path):
    """Whole silent windows mid-file: the guarded coherence and NMF keep
    every output on the card finite and nonzero."""
    path = _long_mix(tmp_path, seconds=6, silence=(40 * 128, 40 * 128 + 4 * 1024))
    out = LongAudioSeparator(OfflineConfig(), device=cuda, chunk_frames=256)\
        .separate_streamed(path, output_prefix=str(tmp_path / "sil"))
    assert np.isfinite(out["mean_angular_spectrum"]).all()
    assert np.isfinite(out["w"]).all()
    for p in out["paths"]:
        x = wav.read_wav(p)[0]
        assert np.isfinite(x).all() and np.abs(x).max() > 0


@pytest.fixture()
def nccl_world(cuda):
    """A world of one over NCCL in this process (make_mesh starts it on a
    private store), ended after the test."""
    import torch.distributed as dist

    from gccnmf_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(device=cuda)
    assert dist.get_backend() == "nccl"
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["unguarded", "guard", "simultaneous"])
def test_sharded_nmf_world_of_one_matches_one_device(nccl_world, mode):
    """kl_nmf_sharded on a (1, 1) NCCL mesh against kl_nmf (kl_nmf_simul for
    the turbo updates) on the card: W and H within 1e-5 x max."""
    from gccnmf_torch.parallel.nmf_sharded import kl_nmf_sharded

    v, w0, h0 = (x[0] for x in _nmf_problem(torch.device("cuda"), b=1, t=517, f=65, k=24))
    kw = {"guard": dict(guard=True), "simultaneous": dict(simultaneous=True)}.get(mode, {})
    got = kl_nmf_sharded(v, w0, h0, 20, nccl_world, **kw)
    if mode == "simultaneous":
        want = kl_nmf_simul(v, w0, h0, 20)
    else:
        want = kl_nmf(v, w0, h0, 20, guard=mode == "guard")
    for g, w_ in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-5 * float(w_.abs().max()))


def test_trainer_world_of_one_resumes_on_card(nccl_world, tmp_path):
    """DistributedNMFTrainer over NCCL: 8 iterations in chunks of 4 equal
    corpus_nmf (1e-5 x max); a trainer resumed at 4 equals it."""
    import shutil

    from gccnmf_torch.parallel.trainer import DistributedNMFTrainer

    rng = np.random.default_rng(0)
    v = (rng.random((300, 65)) + 0.05).astype(np.float32)
    kw = dict(dictionary_size=24, checkpoint_every=4)
    w = DistributedNMFTrainer(nccl_world, num_iterations=8, checkpoint_dir=str(tmp_path / "a"),
                              **kw).fit(v)
    w0, h0 = nmf_init_numpy(65, 24, 300)
    want, _ = pretrain.corpus_nmf(*(torch.as_tensor(x, device="cuda") for x in (v, w0, h0)), 8)
    np.testing.assert_allclose(w, want.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "nmf_000004.npz", tmp_path / "b")
    (tmp_path / "b" / "latest").write_text("nmf_000004.npz")
    resumed = DistributedNMFTrainer(nccl_world, num_iterations=8,
                                    checkpoint_dir=str(tmp_path / "b"), **kw).fit(v)
    np.testing.assert_allclose(resumed, w, rtol=0, atol=1e-5 * float(np.abs(w).max()))


def test_more_time_shards_than_cards_raise(cuda, tmp_path):
    """separate --time-shards N with more shards than cards: make_mesh's
    "exceeds" error before any rank starts; nothing moves to the CPU."""
    path = _long_mix(tmp_path, seconds=2)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"mesh {n + 1}x1 exceeds {n} devices"):
        cli.separate_main([path, "--time-shards", str(n + 1), "-o", str(tmp_path / "x")])
    assert not (tmp_path / "x_sim_1.wav").exists()
