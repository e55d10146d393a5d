"""gccnmf_torch KL-NMF: the seeded init, the XLA-path twins ``kl_nmf`` and
``kl_nmf_simul`` and the kernel's plain version ``kl_nmf_plain`` against JAX
(XLA and Pallas in interpret mode) and the NumPy oracle, on the CPU at the
JAX tests' shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_tpu.ops.nmf_pallas import kl_nmf_pallas
from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.ops import nmf
from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain

import oracle

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def _problem(t=48, f=33, k=8, seed=0, lowrank=False):
    """The JAX suite's NMF problems (test_nmf_pallas.py): uniform positive V,
    or low-rank V plus a floor for the bf16-mode quality checks."""
    rng = np.random.default_rng(seed)
    if lowrank:
        v = (rng.random((t, 4)) + 0.1) @ (rng.random((f, 4)) + 0.1).T + 0.01
    else:
        v = rng.random((t, f)) + 0.05
    w0, h0 = jnmf.nmf_init_numpy(f, k, t)
    st = from_numpy_state({"w0": w0, "h0": h0})
    return v.astype(np.float32), w0, h0, st["w0"], st["h0"]


def _kl(v, w, h):
    w, h = (torch.as_tensor(np.asarray(a, np.float64)) for a in (w, h))
    return float(nmf.kl_divergence(torch.as_tensor(v), w, h))


@pytest.mark.parametrize("f,k,t,seed", [(33, 8, 48, 0), (513, 128, 2486, 0), (17, 4, 9, 3)])
def test_init_bit_equal_to_jax(f, k, t, seed):
    for ours, theirs in zip(nmf.nmf_init_numpy(f, k, t, seed_value=seed),
                            jnmf.nmf_init_numpy(f, k, t, seed_value=seed)):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_init_leaves_global_stream_alone():
    np.random.seed(7)
    want = np.random.random(3)
    np.random.seed(7)
    nmf.nmf_init_numpy(5, 2, 4)
    np.testing.assert_array_equal(np.random.random(3), want)


class TestKLNMF:
    def test_matches_jax_xla_and_oracle(self):
        v, w0, h0, w0t, h0t = _problem()
        w, h = nmf.kl_nmf(torch.from_numpy(v), w0t, h0t, 15)
        w_j, h_j = jnmf.kl_nmf(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 15)
        # 15 fp32 multiplicative iterations: rtol 1e-4 (test_nmf_pallas.py:20-28)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-4)
        w_o, h_o = oracle.kl_nmf_ref(v.T.copy(), 8, 15)  # frequency-major oracle
        np.testing.assert_allclose(w.numpy(), w_o, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_o.T, rtol=1e-4)

    def test_batched_and_sparsity(self):
        v, w0, h0, w0t, h0t = _problem()
        vb = np.stack([v, 1.5 * v])
        w, h = nmf.kl_nmf(torch.from_numpy(vb), w0t, h0t, 8, sparsity_alpha=0.3)
        w_j, h_j = jnmf.kl_nmf(jnp.asarray(vb), jnp.asarray(np.stack([w0, w0])),
                               jnp.asarray(np.stack([h0, h0])), 8, sparsity_alpha=0.3)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-4)

    @pytest.mark.parametrize("guard", [False, True])
    def test_silent_frame_guard_semantics_match_jax(self, guard):
        v, w0, h0, w0t, h0t = _problem()
        v[5] = 0.0  # digital silence: NaN unguarded (reference-exact), 0 guarded
        w, h = nmf.kl_nmf(torch.from_numpy(v), w0t, h0t, 6, guard=guard)
        w_j, h_j = jnmf.kl_nmf(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 6,
                               guard=guard)
        np.testing.assert_array_equal(np.isnan(h.numpy()), np.isnan(np.asarray(h_j)))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4)
        assert guard == bool(np.isfinite(h.numpy()).all())

    def test_kl_divergence_matches_jax(self):
        v, w0, h0, w0t, h0t = _problem()
        got = float(nmf.kl_divergence(torch.from_numpy(v), w0t, h0t))
        want = float(jnmf.kl_divergence(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0)))
        assert got == pytest.approx(want, rel=1e-5)


class TestPlainKernelVersion:
    """``kl_nmf_plain`` is what the CUDA kernel is held against on the card;
    here it is held against the Pallas kernel in interpret mode."""

    def test_float32_matches_pallas_and_xla(self):
        v, w0, h0, w0t, h0t = _problem()
        w, h = kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 15, matmul_dtype="float32")
        w_p, h_p = kl_nmf_pallas(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 15,
                                 matmul_dtype="float32", interpret=True)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_p), rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_p), rtol=1e-4)
        w_x, _ = nmf.kl_nmf(torch.from_numpy(v), w0t, h0t, 15)
        np.testing.assert_allclose(w.numpy(), w_x.numpy(), rtol=1e-4)

    @pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_q", "bfloat16_q_simul"])
    def test_bf16_modes_match_pallas(self, mode):
        v, w0, h0, w0t, h0t = _problem(t=64, f=129, k=16, seed=1, lowrank=True)
        w, h = kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 30, matmul_dtype=mode)
        w_p, h_p = kl_nmf_pallas(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 30,
                                 matmul_dtype=mode, interpret=True)
        # bf16 roundings land at the same points, but the Pallas reciprocal
        # is approximate and sums run in another order: JAX's own stated
        # drift is 4 % (nmf_pallas.py:130), so KL within 2 % and W within 5 %
        kl, kl_p = _kl(v, w, h), _kl(v, w_p, h_p)
        assert abs(kl - kl_p) <= 0.02 * kl_p, (kl, kl_p)
        w_p = np.asarray(w_p)
        assert np.abs(w.numpy() - w_p).max() <= 0.05 * np.abs(w_p).max()
        np.testing.assert_allclose(np.linalg.norm(w.numpy(), axis=0), 1.0, atol=5e-2)

    def test_padded_and_bf16_v(self):
        """A V wider than F (zero columns) and a bf16 V, as the front-end
        emits them, give what the Pallas kernel gives."""
        v, w0, h0, w0t, h0t = _problem(t=24, f=33, k=8, seed=5)
        vp = np.zeros((24, 40), np.float32)
        vp[:, :33] = v
        w, h = kl_nmf_plain(torch.from_numpy(vp), w0t, h0t, 10, matmul_dtype="float32")
        w_p, h_p = kl_nmf_pallas(jnp.asarray(vp), jnp.asarray(w0), jnp.asarray(h0), 10,
                                 matmul_dtype="float32", interpret=True)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_p), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_p), rtol=1e-4, atol=2e-5)
        v16 = torch.from_numpy(v).to(torch.bfloat16)
        w16, _ = kl_nmf_plain(v16, w0t, h0t, 10, matmul_dtype="bfloat16_q")
        w32, _ = kl_nmf_plain(v16.float(), w0t, h0t, 10, matmul_dtype="bfloat16_q")
        np.testing.assert_array_equal(w16.numpy(), w32.numpy())  # same rounding of V

    def test_wrapper_takes_plain_version_on_cpu(self):
        v, _, _, w0t, h0t = _problem()
        before = kl_nmf_cuda.launches
        w, h = kl_nmf_cuda(torch.from_numpy(v), w0t, h0t, 5, matmul_dtype="bfloat16_q")
        w_p, h_p = kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 5, matmul_dtype="bfloat16_q")
        assert kl_nmf_cuda.launches == before  # no kernel ran
        np.testing.assert_array_equal(w.numpy(), w_p.numpy())
        np.testing.assert_array_equal(h.numpy(), h_p.numpy())

    def test_unknown_mode_raises(self):
        v, _, _, w0t, h0t = _problem()
        with pytest.raises(ValueError, match="matmul_dtype"):
            kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 2, matmul_dtype="float16")
        with pytest.raises(ValueError, match="matmul_dtype"):
            kl_nmf_cuda(torch.from_numpy(v), w0t, h0t, 2, matmul_dtype="float16")
        with pytest.raises(ValueError, match="matmul_dtype"):
            nmf.kl_nmf(torch.from_numpy(v), w0t, h0t, 2, matmul_dtype="bfloat16_simul")


class TestTurbo:
    """The turbo mode ("bfloat16_q_simul"): the fp32 twin ``kl_nmf_simul``
    against JAX's, and the kernel's plain version against JAX's invariants
    for the Pallas turbo body (test_nmf_pallas.py:163-247)."""

    @pytest.mark.parametrize("batched", [False, True], ids=["single", "batched-alpha"])
    def test_simul_matches_jax(self, batched):
        v, w0, h0, w0t, h0t = _problem()
        alpha = 0.3 if batched else 0.0
        if batched:
            v = np.stack([v, 1.5 * v])
            w0, h0 = np.stack([w0, w0]), np.stack([h0, h0])
        w, h = nmf.kl_nmf_simul(torch.from_numpy(v), w0t, h0t, 15, sparsity_alpha=alpha)
        w_j, h_j = jnmf.kl_nmf_simul(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 15,
                                     sparsity_alpha=alpha)
        # 15 fp32 iterations of the same updates: rtol 1e-4 (test_nmf_pallas.py:20-28)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-4)
        # the gain restores Σ(WH) = ΣV per element (test_nmf_pallas.py:243-247)
        mass = (w.sum(dim=-2) * h.sum(dim=-2)).sum(dim=-1).numpy()
        np.testing.assert_allclose(mass, v.sum(axis=(-2, -1)), rtol=1e-3)

    def test_plain_kernel_version_finite_and_scale_calibrated(self):
        v, _, _, w0t, h0t = _problem()
        w, h = kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 20, matmul_dtype="bfloat16_q_simul")
        assert torch.isfinite(w).all() and torch.isfinite(h).all()
        assert (w >= 0).all() and (h >= 0).all()
        mass = float((w.sum(0) * h.sum(0)).sum())
        assert mass == pytest.approx(float(v.sum()), rel=2e-2)

    def test_plain_kernel_version_reduces_kl_like_bfloat16_q(self):
        v, _, _, w0t, h0t = _problem()
        kl0 = _kl(v, w0t, h0t)
        kl_std = _kl(v, *kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 25,
                                      matmul_dtype="bfloat16_q"))
        kl_sim = _kl(v, *kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 25,
                                      matmul_dtype="bfloat16_q_simul"))
        assert kl_sim < 0.5 * kl0, (kl_sim, kl0)
        assert kl_sim < 3.0 * kl_std, (kl_sim, kl_std)

    def test_wrapper_takes_plain_version_on_cpu(self):
        v, _, _, w0t, h0t = _problem()
        before = kl_nmf_cuda.launches
        got = kl_nmf_cuda(torch.from_numpy(v), w0t, h0t, 5, matmul_dtype="bfloat16_q_simul")
        want = kl_nmf_plain(torch.from_numpy(v), w0t, h0t, 5, matmul_dtype="bfloat16_q_simul")
        assert kl_nmf_cuda.launches == before  # no kernel ran
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("rows,cols", [(300, 65), (96, 513), (517, 24), (33, 136), (5, 8)])
def test_operand_planes_hold_the_plain_rounding(rows, cols):
    """The tensor-core kernel's bf16 operand planes (Q, and the shadows of
    W and H): rows padded with zeros to 16 bytes, and in the columns that
    count exactly the bf16 values the plain version multiplies."""
    from gccnmf_torch.ops.nmf_cuda import bf16_rows, row_pad
    from gccnmf_torch.precision import round_bf16

    x = torch.as_tensor(np.random.default_rng(rows).random((2, rows, cols), np.float32) + 1e-3)
    plane = bf16_rows(x)
    assert plane.dtype == torch.bfloat16 and plane.is_contiguous()
    assert plane.shape == (2, rows, row_pad(cols))
    assert row_pad(cols) % 8 == 0 and cols <= row_pad(cols) < cols + 8
    assert torch.equal(plane[..., :cols].float(), round_bf16(x))
    assert not plane[..., cols:].any()


# T at the edges of both split rules: one split, a partial 16-row round,
# the reference 2,486 rows, both rules' caps (16 and 32 splits), the
# corpus, past 16 × 4,096 rows and the hour's 899,986
SPLIT_TS = [1, 17, 255, 257, 2486, 4097, 4609, 20000, 65537, 70000, 899986]


@pytest.mark.parametrize("t", SPLIT_TS)
def test_float32_splits_cover_every_row_in_order(t):
    """The float32 mode's Qᵀ·H splits (kernel mode 0): a function of T
    alone, consecutive rows of a multiple of 16 that cover [0, T) with no
    empty split, and never fewer than the bf16 modes' rule gives (past 16 ×
    4,096 rows, more than its cap of 16)."""
    from gccnmf_torch.ops.nmf_cuda import _splits, _splits_simt

    splits, rows = _splits_simt(t)
    assert rows % 16 == 0 and splits >= 1
    assert (splits - 1) * rows < t <= splits * rows  # every row, the last split non-empty
    assert splits >= _splits(t)[0]
    assert _splits_simt(t) == (splits, rows)  # T alone decides it
    if t > 16 * 4096:
        assert splits > 16 and rows <= 4096


def test_float32_splits_at_the_hour_and_reference():
    from gccnmf_torch.ops.nmf_cuda import _splits_simt

    assert _splits_simt(899986) == (220, 4096)
    assert _splits_simt(2486) == (20, 128)  # twice the bf16 modes' 10
    assert _splits_simt(20000) == (32, 640)


@pytest.mark.parametrize("t,want", [(1, (1, 16)), (255, (1, 256)), (2486, (10, 256)),
                                    (20000, (16, 1264)), (899986, (16, 56256))])
def test_bf16_modes_keep_their_splits(t, want):
    """Modes 1–3 keep their rule: ≈256 rows a split, at most 16."""
    from gccnmf_torch.ops.nmf_cuda import _splits

    assert _splits(t) == want


@pytest.mark.parametrize("md,k,want", [
    ("bfloat16", 128, True), ("bfloat16_q", 128, True), ("bfloat16_q", 13, True),
    ("bfloat16", 136, True), ("bfloat16_q", 256, True), ("bfloat16", 257, False),
    ("bfloat16_q", 264, False), ("bfloat16_q", 1024, False), ("bfloat16_q_simul", 128, False),
    ("bfloat16_q_simul", 24, False), ("float32", 128, False), ("float32", 256, False)])
def test_q_on_chip_route_is_mode_and_k_alone(md, k, want):
    """Kernel 1 keeps Q on chip in modes 1 and 2 at K <= 256 and
    materialises it above; turbo and float32 never take the route. Nothing
    else (T, F, the batch, the device) enters the rule."""
    from gccnmf_torch.ops.nmf_cuda import q_on_chip

    assert q_on_chip(md, k) is want


def test_q_on_chip_rejects_an_unknown_mode():
    from gccnmf_torch.ops.nmf_cuda import q_on_chip

    with pytest.raises(ValueError, match="unknown matmul_dtype"):
        q_on_chip("float16", 128)


@pytest.mark.parametrize("dtype,fv,f,mode,want_dtype,want_fv,same", [
    (torch.bfloat16, 513, 513, 2, torch.bfloat16, 520, False),  # the front-end's V plane
    (torch.float32, 513, 513, 2, torch.bfloat16, 520, False),  # mode 2 rounds V to bf16 first
    (torch.float32, 65, 65, 1, torch.float32, 68, False),  # mode 1 keeps fp32 V
    (torch.bfloat16, 72, 65, 2, torch.bfloat16, 72, True),  # already 16-byte rows
    (torch.float32, 516, 513, 1, torch.float32, 516, True),
    (torch.bfloat16, 80, 65, 1, torch.bfloat16, 80, True)])
def test_on_chip_v_rows(dtype, fv, f, mode, want_dtype, want_fv, same):
    """The on-chip route's V: rows of whole 16-byte chunks, bf16 in mode 2,
    the first F columns equal to V's (cast to bf16 in mode 2, which the
    ratio does first anyway); V itself where it already lies so."""
    from gccnmf_torch.ops.nmf_cuda import _v_rows

    v = torch.rand((2, 7, fv)).to(dtype)
    got, ld = _v_rows(v, f, mode)
    assert got.dtype == want_dtype and ld == want_fv and got.shape == (2, 7, want_fv)
    assert (got is v) is same
    torch.testing.assert_close(got[..., :f], v[..., :f].to(want_dtype), rtol=0, atol=0)
