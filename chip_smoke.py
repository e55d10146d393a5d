#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gccnmf_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``. It
needs one card and a CUDA toolkit (``nvcc``), and imports nothing of JAX or
of ``gccnmf_tpu``. Phases, one JSON line each:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; asserts TF32 is off for matmuls and cuDNN.
2. ``build``: builds every kernel under ``gccnmf_torch/csrc`` with ``nvcc``.
3. ``kernel``: each kernel and mode at the reference shapes (batch 2, a 10 s
   16 kHz stereo mixture made from ``--seed``) against its plain PyTorch
   version on the card, twice (bit-identical), with CUDA-event times of
   kernel and plain version and the card's bound for the same work; then
   the default config's modes again at batch 16, the NMF at its full 100
   iterations, which are the shapes ``separate_batch`` gives them.
4. ``separate``: the default ``GCCNMFSeparator()`` (``bfloat16_q``) through
   ``separate`` (3 sources) and ``separate_batch`` (16 utterances), with the
   kernels' launch counters set to 0 just before each path and read just
   after it; every utterance of the batch is held against ``separate`` of
   it alone. ``mode``: the same ``separate`` with
   ``nmf_matmul_dtype="bfloat16"``.
5. ``parity``: float32 mode, all kernels against the plain torch path on the
   card: equal targets and > 25 dB SNR per target.
6. ``profile``: one default ``separate_batch`` under ``torch.profiler``:
   device time by stage, the top kernels, and the device's idle share.

Then the kernels line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SR, SECONDS, WIN, HOP, K, D, SOURCES = 16000, 10, 1024, 128, 128, 128, 3
KERNEL_BATCH, MAIN_BATCH, NMF_CHECK_ITERS, NMF_ITERS = 2, 16, 15, 100
# separate_batch(mix)[i] against separate(mix[i]), max |diff| over max
# |separate|: the same kernels at B = 16 and B = 1 (the NMF's split sums
# depend on T only), so only the attribution GEMM's summation order may
# differ; on an H100 the two read bit-equal
BATCH_TOL = 1e-5

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at its 700 W
# limit): 3.35 TB/s of HBM, 67 TFLOP/s fp32 on the SIMT cores, 989 TFLOP/s
# bf16 on the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "bfloat16": 989e12, "bfloat16_q": 989e12}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_mixture(seed: int, batch: int) -> np.ndarray:
    """(batch, 2, n) float32: three white-noise sources at 0.1 RMS, delayed
    by 8, -11 and 3 samples between the mics (as bench.py's synthetic
    fallback does with two)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((batch, SOURCES, SR * SECONDS), dtype=np.float32) * 0.1
    right = sum(np.roll(src[:, i], d, axis=-1) for i, d in enumerate((8, -11, 3)))
    return np.stack([src.sum(axis=1), right], axis=1).astype(np.float32)


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, mode: str) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the HBM rate
    and operations over the peak rate for the GEMM operand type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[mode]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(torch, got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    return float(10 * np.log10((ref**2).sum() / max(((ref - est) ** 2).sum(), 1e-30)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from gccnmf_torch import _build
    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
    from gccnmf_torch.ops import gcc, localize, masks
    from gccnmf_torch.ops.frontend_cuda import (
        frontend_basis, stft_gcc_frontend_cuda, stft_gcc_frontend_plain,
    )
    from gccnmf_torch.ops.nmf import kl_divergence, nmf_init_numpy
    from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain
    from gccnmf_torch.ops.synthesis_cuda import (
        masked_synthesis_cuda, masked_synthesis_plain, synthesis_basis,
    )
    from gccnmf_torch.ops.windows import hann_symmetric
    from gccnmf_torch.precision import set_fp32_precision

    wrappers = {"stft_gcc_frontend_cuda": stft_gcc_frontend_cuda,
                "kl_nmf_cuda": kl_nmf_cuda, "masked_synthesis_cuda": masked_synthesis_cuda}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    set_fp32_precision()
    require(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(), tf32=False)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=os.path.relpath(
        lib._name, ROOT))

    # ---- 3. kernels against their plain versions ---------------------------
    mix = make_mixture(args.seed, MAIN_BATCH)
    n = mix.shape[-1]
    window = hann_symmetric(WIN)
    f = WIN // 2 + 1
    cos_np, sin_np = gcc.steering_cos_sin(float(SR), f, 1.0, D)
    cos_m, sin_m = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    fbasis = frontend_basis(window, conjugate=True, device=dev)
    sbasis = synthesis_basis(window, HOP / WIN * 2.0, device=dev)
    t = 1 + (n - WIN) // HOP
    w0_np, h0_np = nmf_init_numpy(f, K, 2 * t)
    rows = []

    def record(name, mode, b, source, replaces, got, want, tol, kernel_fn, plain_fn,
               flops, nbytes, check_fn=None, err=None, note="", **extra):
        """Check ``got`` (a tuple of the kernel's outputs) against the plain
        version's ``want``, rerun the kernel (``check_fn``, default
        ``kernel_fn``) for bit-identity, time both, and keep the row."""
        label = f"{name}[{mode}]" + ("" if b == KERNEL_BATCH else f"@B{b}")
        again = (check_fn or kernel_fn)()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        require(same, f"{label} is not bit-identical across two runs")
        if err is None:
            err, scale = max(max_err(torch, g, w) for g, w in zip(got, want))
            require(err <= tol * scale, f"{label} max abs err {err} > {tol} x {scale}")
        b_ms, b_by = bound(flops, nbytes, mode)
        row = dict(name=label, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, ms=time_ms(torch, kernel_fn),
                   plain_ms=time_ms(torch, plain_fn), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, tolerance=note, bit_identical=True, batch=b,
                   kernel=name, mode=mode,
                   bound_basis=(f"{flops:.4g} flop at {PEAK_FLOP_S[mode] / 1e12:g} TFLOP/s, "
                                f"{nbytes:.4g} B at 3.35 TB/s (H100 SXM data sheet)"),
                   **extra)
        emit("kernel", **row)
        rows.append(row)

    def check_kernels(b, fe_modes, nmf_modes, syn_modes, nmf_check_iters):
        """Each kernel at batch ``b`` of the reference shapes against its
        plain version. The first front-end mode's planes feed the NMF and
        the attribution, and the first NMF mode's W and H the synthesis, as
        they do on the main path."""
        x = torch.as_tensor(mix[:b], device=dev)
        planes = {}
        for md in fe_modes:
            kw = dict(hop_size=HOP, matmul_dtype=md, plane_dtype=md)
            kfn = lambda kw=kw: stft_gcc_frontend_cuda(x, fbasis, cos_m, sin_m, **kw)
            pfn = lambda kw=kw: stft_gcc_frontend_plain(x, fbasis, cos_m, sin_m, **kw)
            got, want = kfn(), pfn()
            planes[md] = got
            psize = 4 if md == "float32" else 2
            record(
                "stft_gcc_frontend_cuda", md, b, "gccnmf_torch/csrc/frontend.cu",
                "gccnmf_tpu/ops/frontend_pallas.py:111", got, want,
                1e-4 if md == "float32" else 8e-3, kfn, pfn,
                flops=b * (8 * t * WIN * f + 4 * t * f * D),
                nbytes=b * 2 * n * 4 + 4 * (2 * WIN * f + 2 * f * D)
                + b * psize * (3 * 2 * t * f + 2 * t * f) + b * t * D * 4,
                note=("1e-4" if md == "float32" else "8e-3 (one bf16 step)") + " x max|plain|",
            )
            del want
        feed = planes[fe_modes[0]]

        # NMF on the mixture's |X| (left‖right), the main path's V
        v = feed[2].reshape(b, 2 * t, f)
        w0 = torch.as_tensor(w0_np, device=dev).expand(b, f, K)
        h0 = torch.as_tensor(h0_np, device=dev).expand(b, 2 * t, K)
        nmf_out = {}
        for md in nmf_modes:
            got = kl_nmf_cuda(v, w0, h0, nmf_check_iters, matmul_dtype=md)
            want = kl_nmf_plain(v, w0, h0, nmf_check_iters, matmul_dtype=md)
            nmf_out[md] = got
            err = max(max_err(torch, g, w)[0] for g, w in zip(got, want))
            if md == "float32":
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=1e-4,
                                               atol=1e-6 * float(w.abs().max()))
                note = f"{nmf_check_iters} iterations: rtol 1e-4, atol 1e-6 x max|plain|"
            else:
                kl_k, kl_p = (float(kl_divergence(v, w.double(), h.double()))
                              for w, h in (got, want))
                w_rel, h_rel = (max_err(torch, g, w) for g, w in zip(got, want))
                require(abs(kl_k - kl_p) <= 0.02 * kl_p, f"kl_nmf[{md}] KL {kl_k} vs {kl_p}")
                require(w_rel[0] <= 0.01 * w_rel[1], f"kl_nmf[{md}] W drift {w_rel}")
                require(h_rel[0] <= 0.01 * h_rel[1], f"kl_nmf[{md}] H drift {h_rel}")
                note = (f"{nmf_check_iters} iterations: KL within 2 % "
                        f"({abs(kl_k - kl_p) / kl_p:.2e}), max|dW| <= 1 % of max|W| "
                        f"({w_rel[0] / w_rel[1]:.2e}), max|dH| <= 1 % of max|H| "
                        f"({h_rel[0] / h_rel[1]:.2e})")
            del want
            record(
                "kl_nmf_cuda", md, b, "gccnmf_torch/csrc/nmf.cu",
                "gccnmf_tpu/ops/nmf_pallas.py:218", got, None, 0.0,
                lambda md=md: kl_nmf_cuda(v, w0, h0, NMF_ITERS, matmul_dtype=md),
                lambda md=md: kl_nmf_plain(v, w0, h0, NMF_ITERS, matmul_dtype=md),
                flops=8 * b * 2 * t * f * K * NMF_ITERS,
                nbytes=b * 2 * t * f * v.element_size() + 2 * 4 * b * (f * K + 2 * t * K),
                check_fn=lambda md=md: kl_nmf_cuda(v, w0, h0, nmf_check_iters,
                                                   matmul_dtype=md),
                err=err, note=note, iterations_timed=NMF_ITERS,
            )

        # synthesis on those planes, W and H, and the device peak picking
        w_nmf, h_nmf = nmf_out[nmf_modes[0]]
        tgt = localize.top_k_peaks(gcc.mean_angular_spectrum(feed[5]), SOURCES)
        winner = masks.attribution_winner_planes(feed[3], feed[4], cos_m, sin_m, tgt, w_nmf)
        h_st = torch.stack([h_nmf[:, :t], h_nmf[:, t:]], dim=1)
        for md in syn_modes:
            sre, sim = planes[md][0], planes[md][1]
            kw = dict(num_targets=SOURCES, hop_size=HOP, matmul_dtype=md)
            kfn = lambda sre=sre, sim=sim, kw=kw: masked_synthesis_cuda(
                sre, sim, winner, w_nmf, h_st, sbasis, **kw)
            pfn = lambda sre=sre, sim=sim, kw=kw: masked_synthesis_plain(
                sre, sim, winner, w_nmf, h_st, sbasis, **kw)
            tol = 1e-4 if md == "float32" else 1e-2
            psize = 4 if md == "float32" else 2
            record(
                "masked_synthesis_cuda", md, b, "gccnmf_torch/csrc/synthesis.cu",
                "gccnmf_tpu/ops/synthesis_pallas.py:140", (kfn(),), (pfn(),), tol, kfn, pfn,
                flops=2 * b * SOURCES * 2 * t * f * (K + 2 * WIN),
                nbytes=b * (2 * 2 * t * f * psize + t * K * 4 + f * K * 4 + 2 * t * K * 4)
                + 2 * f * WIN * 4 + b * SOURCES * 2 * (t - 1) * HOP * 4,
                check_fn=lambda kfn=kfn: (kfn(),),
                note=("1e-4" if md == "float32" else "1e-2 (bf16 operands)") + " x max|plain|",
            )

    # every mode at batch 2, the NMF checked after 15 iterations
    check_kernels(KERNEL_BATCH, ("float32", "bfloat16"), ("float32", "bfloat16", "bfloat16_q"),
                  ("float32", "bfloat16"), NMF_CHECK_ITERS)
    # the default config's modes at the batched main path's shapes, the NMF
    # checked at its full 100 iterations
    check_kernels(MAIN_BATCH, ("bfloat16",), ("bfloat16_q",), ("bfloat16",), NMF_ITERS)
    torch.cuda.empty_cache()

    # ---- 4. the main path: GCCNMFSeparator() -------------------------------
    def drive(cfg, batch: bool):
        """``separate`` (and ``separate_batch`` when ``batch``), each after
        a warm-up, with the launch counts set to 0 just before each path
        and read just after it."""
        sep = GCCNMFSeparator(cfg)
        sep.separate(mix[0])  # warm-up: allocator, cuBLAS handles
        if batch:
            sep.separate_batch(mix)
        out = dict(counts={})
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["single"] = sep.separate(mix[0])
        out["s_single"] = time.perf_counter() - t1
        out["counts"]["separate"] = counts()
        if batch:
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out["batch"] = sep.separate_batch(mix)
            out["s_batch"] = time.perf_counter() - t1
            out["counts"]["separate_batch"] = counts()
        for path, c in out["counts"].items():
            require(all(v > 0 for v in c.values()),
                    f"{cfg.nmf_matmul_dtype} {path}: a kernel never launched: {c}")
        out["sep"], out["mode"] = sep, cfg.nmf_matmul_dtype
        return out

    n_out = (t - 1) * HOP
    main = drive(OfflineConfig(), batch=True)
    est, targets = main["batch"]
    single = main["single"]
    require(single["estimates"].shape == (SOURCES, 2, n_out), "separate: wrong shape")
    require(est.shape == (MAIN_BATCH, SOURCES, 2, n_out), "separate_batch: wrong shape")
    require(np.isfinite(single["estimates"]).all() and np.isfinite(est).all(),
            "non-finite estimates")
    # every utterance of the batch against separate() of it alone: the same
    # kernels at B = 1, so this holds the B = 16 buffers element by element
    batch_snr, batch_err, scale = [], 0.0, 0.0
    for i in range(MAIN_BATCH):
        one = single if i == 0 else main["sep"].separate(mix[i])
        require(list(targets[i]) == one["target_tdoa_indexes"],
                f"separate_batch[{i}] targets {list(targets[i])} != "
                f"{one['target_tdoa_indexes']}")
        batch_err = max(batch_err, float(np.abs(est[i] - one["estimates"]).max()))
        scale = max(scale, float(np.abs(one["estimates"]).max()))
        batch_snr.append(min(snr_db(r, e) for r, e in zip(one["estimates"], est[i])))
    require(batch_err <= BATCH_TOL * scale,
            f"separate_batch against separate: max abs err {batch_err} > "
            f"{BATCH_TOL} x {scale}")
    emit("separate", device=kind, nvidia_smi=smi, config="OfflineConfig() (bfloat16_q)",
         targets=single["target_tdoa_indexes"], launches=main["counts"],
         separate_s=main["s_single"], separate_audio_s_per_s=SECONDS / main["s_single"],
         batch=MAIN_BATCH, separate_batch_s=main["s_batch"],
         separate_batch_audio_s_per_s=MAIN_BATCH * SECONDS / main["s_batch"],
         batch_vs_separate=dict(max_abs_err=batch_err, bar=f"{BATCH_TOL} x {scale}",
                                min_snr_db=min(batch_snr)))

    bf16 = drive(OfflineConfig(nmf_matmul_dtype="bfloat16"), batch=False)
    require(bf16["single"]["target_tdoa_indexes"] == single["target_tdoa_indexes"],
            "bfloat16 mode picks other targets")
    emit("mode", nmf_matmul_dtype="bfloat16", launches=bf16["counts"],
         separate_s=bf16["s_single"], targets=bf16["single"]["target_tdoa_indexes"])
    del main["sep"], bf16["sep"]

    # ---- 5. float32 parity: kernels against the plain torch path ----------
    cfg32 = OfflineConfig(nmf_matmul_dtype="float32")
    f32 = drive(cfg32, batch=False)
    del f32["sep"]
    plain = GCCNMFSeparator(dataclasses.replace(
        cfg32, nmf_backend="torch", synthesis_backend="torch", frontend_backend="torch"
    )).separate(mix[0])
    got, want = f32["single"], plain
    require(got["target_tdoa_indexes"] == want["target_tdoa_indexes"],
            f"parity targets {got['target_tdoa_indexes']} != {want['target_tdoa_indexes']}")
    snrs = [snr_db(r, e) for r, e in zip(want["estimates"], got["estimates"])]
    require(min(snrs) > 25.0, f"parity SNR {snrs}")
    emit("parity", nmf_matmul_dtype="float32", targets=got["target_tdoa_indexes"],
         snr_db=snrs, launches=f32["counts"],
         mask_agreement=float((got["coefficient_masks"] == want["coefficient_masks"]).mean()))

    # ---- 6. where the time goes: one separate_batch under torch.profiler --
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sep = GCCNMFSeparator(OfflineConfig())
    sep.separate_batch(mix)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        sep.separate_batch(mix)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    stages = {"kl_nmf_cuda": ("wh_ratio", "h_update", "qth_split", "w_update",
                              "col_reduce", "renorm"),
              "stft_gcc_frontend_cuda": ("dft_coherence", "angular_kernel"),
              "masked_synthesis_cuda": ("spectra_kernel", "frames_kernel", "ola_kernel")}
    device_ms = dict.fromkeys([*stages, "other"], 0.0)
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.device_time_total / 1e3
        stage = next((s for s, keys in stages.items() if any(k in ev.key for k in keys)),
                     "other")
        device_ms[stage] += ms
        top.append((ms, ev.key[:80], ev.count))
    busy = sum(device_ms.values())
    emit("profile", call=f"separate_batch (B={MAIN_BATCH}, OfflineConfig())",
         wall_ms=wall_ms, device_busy_ms=busy if busy else "not measured",
         device_ms_by_stage=device_ms,
         idle_share=(1.0 - busy / wall_ms) if busy else "not measured",
         top_kernels=[dict(ms=m, name=k, calls=c) for m, k, c in sorted(top)[::-1][:12]])

    # launches of each kernel on the main path that runs it at its mode and
    # batch: separate_batch for the B = 16 rows, separate for the B = 2 rows;
    # bf16 front-end and synthesis GEMMs belong to the default config
    runs = {"float32": f32, "bfloat16": bf16, "bfloat16_q": main}
    for row in rows:
        name, mode = row["kernel"], row["mode"]
        run = main if (mode == "bfloat16" and name != "kl_nmf_cuda") else runs[mode]
        path = "separate_batch" if row["batch"] == MAIN_BATCH else "separate"
        row["launches"] = run["counts"][path][name]
        row["launches_on"] = f"{path}, nmf_matmul_dtype={run['mode']!r}"
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
