#!/usr/bin/env python3
"""Time the float32 bodies of the kernels on one NVIDIA GPU (kernels 1 and
4 on the SIMT product core, kernels 2 and 5 on the iDFT's FFT, kernel 3 on
the rDFT's FFT), so that two trees can be compared in one call.

Run from the root of a checkout:
``python3 chip_simt_rows.py [--root DIR] [--rows nmf_ref,nmf_corpus,nmf_hour,mask,
syn,wiener,syn16,wiener16,frontend,frontend16,nmf_edge,nmf_cap,paths] [--label NAME]
[--seed N] [--profile]``. It imports
``gccnmf_torch`` from ``--root`` (default: this checkout), builds that
tree's kernels there, prints the ptxas registers and spills of its float32
product and iDFT kernels, and then, per row, one JSON line:

- ``nmf_ref``: ``kl_nmf_cuda`` float32 at the reference shape (B = 2 of
  10 s, T = 2,486 rows of left‖right, F = 513, K = 128), V = |X| of the
  seeded three-source mixtures of ``chip_smoke.py`` (``--seed``);
- ``nmf_corpus``: B = 1, T = 20,000, K = 256 (the pretraining corpus'
  shape), V = the first 20,000 rows of |X| of an 81 s seeded mixture;
- ``nmf_hour``: B = 1, T = 899,986, K = 128 (one audio hour's NMF), V =
  |X| of an hour of white noise drawn on the card (three sources, the
  mixture's delays);
- ``mask``: ``soft_mask_cuda`` float32 at B = 2 on ``bench.py``'s
  enhancement configuration (10 cm, 128 TDOAs, K = 128), its coherence
  planes from the 10 s mixtures (one frame NaN), a seeded positive W;
- ``syn``: ``masked_synthesis_cuda`` float32 at B = 2 of the 10 s mixtures
  (3 targets, 2 channels, T = 1,243, K = 128, hop 128): the mixtures'
  STFT planes, a seeded positive W and H and a seeded winner;
- ``wiener``: ``tf_synthesis_cuda`` float32 at B = 2 on the same planes,
  a seeded mask and dictionary (K = 128);
- ``syn16`` and ``wiener16``: the same two in the bf16 mode (the
  tensor-core iDFT), held within 1e-2 x max|plain|, without yardsticks;
- ``frontend``: ``stft_gcc_frontend_cuda`` float32 at B = 2 of the 10 s
  mixtures (window 1,024, hop 128, T = 1,243, F = 513, 128 TDOAs over
  1 m), held within 1e-4 x max of the plain version (spec, |X|, angular)
  and its coherence planes within 1e-4 x max of the plain version or of
  the function in float64, whichever is nearer (an earlier tree's GEMM
  sits by the plain version, the FFT by float64; all three distances are
  printed), with
  ``gemm_library_ms`` (the rDFT and angular products as ``torch.matmul``)
  and ``fft_library_ms`` (the windowed frames through ``torch.fft.rfft``
  plus the angular ``torch.matmul``); ``frontend16``: the same in bf16
  (the tensor cores), within 8e-3 x max|plain|, without yardsticks;
- ``paths``: the float32 entry points at B = 1 on the first 10 s mixture,
  ``GCCNMFSeparator(OfflineConfig(nmf_matmul_dtype="float32")).separate``
  and ``GCCNMFEnhancer`` (a seeded positive K = 128 dictionary, 10 cm, 128
  TDOAs) ``.enhance``, each the median wall time of 5 calls after a
  warm-up (host clock around a synchronised call);
- ``nmf_edge`` and ``nmf_cap``: ``kl_nmf_cuda`` float32 on V of 4,194,240
  rows (the last row count whose H update fits one grid: 65,535 tiles of
  64) and of 4,194,304 (past CUDA's cap on gridDim.y), F = 33, K = 8, V
  drawn on the card from ``--seed``, 3 iterations against the plain
  updates (a tree that cannot launch it prints its error).

The NMF rows print ``digest``, a SHA-256 of W and H after the checked
iterations, the synthesis rows one of their output and the front-end rows
one of their six planes, so two trees' results can be compared bit for
bit.

Each row checks the kernel against its plain version (the NMF after 15
iterations within rtol 1e-4, atol 1e-6 x max|plain|; the soft mask's
argmax flips only at near-ties and its masks within 2 fp32 ulps elsewhere,
the NaN frame at TDOA 0; the syntheses within 1e-4 x max|plain|), reruns
it for bit-identity (and, at B = 2, the second element alone), then times
the kernel (the NMF at 100 iterations), its plain version and the
yardstick ``gemm_library_ms`` (the same products as ``torch.matmul``,
TF32 off; for the syntheses their iDFT alone, and ``fft_library_ms``, the
same rows as ``torch.fft.irfft`` times the window) with CUDA events: the
median of 5 after a warm-up (3 at the corpus shape; one call each at the
hour). The bound is ``chip_smoke.py``'s: the larger of the bytes over 3.35
TB/s and the least operations over 67 TFLOP/s fp32 (a float32 DFT counted
as an FFT, 2.5·N·log2 N a frame).

To compare a parent tree, unpack it (``git archive``) into an ignored
directory and run, in one call: ``--root <parent>``, then this tree twice,
then the parent again. ``--profile`` adds each row's device time by kernel
(torch.profiler: one NMF call of 2 iterations, per iteration; one soft-mask
call; one synthesis call). Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SR, WIN, HOP = 16000, 1024, 128
F = WIN // 2 + 1
DELAYS = (8, -11, 3)
CHECK_ITERS, ITERS = 15, 100
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
PRODUCT_KERNELS = ("wh_ratio_kernel", "h_update_kernel", "qth_split_kernel",
                   "score_argmax_kernel", "frames_kernel", "coherence_kernel")
# 65,536 row tiles of 64: one past what one grid's y holds
EDGE_ROWS, CAP_ROWS = 65535 * 64, 65536 * 64


def mixture(seed: int, batch: int, seconds: int) -> np.ndarray:
    """(batch, 2, n): chip_smoke.make_mixture's three white-noise sources."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((batch, 3, SR * seconds), dtype=np.float32) * 0.1
    right = sum(np.roll(src[:, i], d, axis=-1) for i, d in enumerate(DELAYS))
    return np.stack([src.sum(axis=1), right], axis=1).astype(np.float32)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--rows", default="nmf_ref,nmf_corpus,nmf_hour,mask,syn,wiener")
    parser.add_argument("--label", default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print each row's device time by kernel (torch.profiler)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("chip_simt_rows: CUDA is not available", file=sys.stderr)
        return 1
    from gccnmf_torch import _build
    from gccnmf_torch.ops import gcc
    from gccnmf_torch.ops import stft as stft_ops
    from gccnmf_torch.ops.enhance_cuda import (
        argmax_flips, soft_mask_basis, soft_mask_cuda, soft_mask_plain, tf_synthesis_basis,
        tf_synthesis_cuda, tf_synthesis_plain,
    )
    from gccnmf_torch.ops.synthesis_cuda import (
        masked_synthesis_cuda, masked_synthesis_plain, synthesis_basis,
    )
    from gccnmf_torch.ops.nmf import nmf_init_numpy
    from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain
    from gccnmf_torch.ops.windows import hann_symmetric

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    label = args.label or root
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = _build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(log[:-2]):
        if "Function properties for" in line and any(k in line for k in PRODUCT_KERNELS):
            name = line.split("Function properties for")[1].strip()
            if "tc_" not in name:
                ptxas[name] = f"{log[i + 2].split(':', 1)[1].strip()}; {log[i + 1].strip()}"
    print(json.dumps(dict(label=label, root=root, device=smi, build_s=build_s, ptxas=ptxas)),
          flush=True)
    window = torch.as_tensor(hann_symmetric(WIN), device=dev)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out), out

    def mags(x):  # (B, 2, n) → |X| (B, 2T, F), left‖right
        spec = stft_ops.stft(x, window, HOP, conjugate=True)
        return spec.abs().reshape(x.shape[0], -1, F)

    def emit(**row):
        print(json.dumps(dict(label=label, device=smi, **row)), flush=True)

    def by_kernel(fn, per=1):
        """Device ms of one ``fn()`` by kernel name (torch.profiler), over ``per``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a throwaway kernel first: a profiling run after the first has been
            # seen to drop its first kernel
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        out = {ev.key[:80]: ev.device_time_total / 1e3 / per for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0
               and "elementwise" not in ev.key and "fill" not in ev.key.lower()}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def digest(*tensors):
        h = hashlib.sha256()
        for x in tensors:
            x = x.detach().contiguous()
            x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x  # the bits, for NumPy
            h.update(x.cpu().numpy().tobytes())
        return h.hexdigest()

    def nmf_row(name, v, k, reps):
        b, t = v.shape[0], v.shape[1]
        w0n, h0n = nmf_init_numpy(F, k, t)
        w0 = torch.as_tensor(w0n, device=dev).expand(b, F, k)
        h0 = torch.as_tensor(h0n, device=dev).expand(b, t, k)
        got = kl_nmf_cuda(v, w0, h0, CHECK_ITERS, matmul_dtype="float32")
        want = kl_nmf_plain(v, w0, h0, CHECK_ITERS, matmul_dtype="float32")
        err = 0.0
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-6 * float(p.abs().max()))
            err = max(err, float((g - p).abs().max()))
        del want
        sha = digest(*got)
        again = kl_nmf_cuda(v, w0, h0, CHECK_ITERS, matmul_dtype="float32")
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        alone = None
        if b > 1:
            one = kl_nmf_cuda(v[1:2].clone(), w0[:1], h0[:1], CHECK_ITERS, matmul_dtype="float32")
            alone = all(torch.equal(g[1], o[0]) for g, o in zip(got, one))
        del got, again
        if not same or alone is False:
            raise RuntimeError(f"{name}: not bit-identical (rerun {same}, alone {alone})")
        ms, runs = timed(lambda: kl_nmf_cuda(v, w0, h0, ITERS, matmul_dtype="float32"), reps)
        plain_ms, plain_runs = timed(lambda: kl_nmf_plain(v, w0, h0, ITERS,
                                                          matmul_dtype="float32"), reps)
        hb, wb, q = (torch.rand(s, device=dev) for s in ((b, t, k), (b, F, k), (b, t, F)))
        lib_ms, _ = timed(lambda: (hb @ wb.transpose(-1, -2), q @ wb,
                                   q.transpose(-1, -2) @ hb, hb @ wb.transpose(-1, -2)),
                          max(reps, 3))
        del hb, wb, q
        flops = 8 * b * t * F * k * ITERS
        nbytes = b * t * F * 4 + 2 * 4 * b * (F * k + t * k)
        bound_ms = max(flops / FP32_FLOP_S, nbytes / HBM_BYTES_S) * 1e3
        prof = (by_kernel(lambda: kl_nmf_cuda(v, w0, h0, 2, matmul_dtype="float32"), 2)
                if args.profile else None)
        torch.cuda.empty_cache()
        emit(row=name, shape=dict(B=b, T=t, F=F, K=k, iterations=ITERS), ms=ms, runs=runs,
             device_ms_per_iteration=prof,
             tflop_s=flops / ms / 1e9, plain_ms=plain_ms, plain_runs=plain_runs,
             gemm_library_ms=lib_ms * ITERS, bound_ms=bound_ms, bound_by="operations",
             max_abs_err=err, bar="15 iterations: rtol 1e-4, atol 1e-6 x max|plain|",
             bit_identical=True, batch_element_alone=alone, digest=sha)

    def cap_row(name, t):
        f, k, iters = 33, 8, 3
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + t)
        v = ((torch.rand((t, 4), generator=gen, device=dev) + 0.1)
             @ (torch.rand((f, 4), generator=gen, device=dev) + 0.1).T + 0.01)[None]
        w0, h0 = (torch.as_tensor(m, device=dev)[None] for m in nmf_init_numpy(f, k, t))
        try:
            got = kl_nmf_cuda(v, w0, h0, iters, matmul_dtype="float32")
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a tree whose grid cannot hold the row tiles
            emit(row=name, shape=dict(B=1, T=t, F=f, K=k, iterations=iters), error=str(exc))
            return
        want = kl_nmf_plain(v, w0, h0, iters, matmul_dtype="float32")
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-6 * float(p.abs().max()))
        err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        ms, runs = timed(lambda: kl_nmf_cuda(v, w0, h0, iters, matmul_dtype="float32"), 3)
        emit(row=name, shape=dict(B=1, T=t, F=f, K=k, iterations=iters), ms=ms, runs=runs,
             max_abs_err=err, bar="rtol 1e-4, atol 1e-6 x max|plain|", digest=digest(*got))
        del v, w0, h0, got, want
        torch.cuda.empty_cache()

    def synthesis_row(name, kfn, pfn, one_fn, frames, flops, nbytes, tol=1e-4):
        got, again, want = kfn(), kfn(), pfn()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        checks = dict(rerun=bool(torch.equal(got, again)),
                      alone=bool(torch.equal(got[1:2], one_fn())), within_tol=err <= tol * scale)
        if not all(checks.values()):
            raise RuntimeError(f"{name}: {checks} (err {err}, scale {scale})")
        ms, runs = timed(kfn, 5)
        plain_ms, plain_runs = timed(pfn, 5)
        gemm_ms = fft_ms = None
        if tol == 1e-4:  # the float32 rows' yardsticks
            xr = torch.rand((frames, 2 * F), device=dev)
            basis_ = torch.rand((2 * F, WIN), device=dev)
            gemm_ms, _ = timed(lambda: xr @ basis_, 5)
            xc = torch.complex(xr[:, :F].contiguous(), xr[:, F:].contiguous())
            win_ = torch.rand(WIN, device=dev)
            fft_ms, _ = timed(lambda: torch.fft.irfft(xc, n=WIN) * win_, 5)
            del xr, basis_, xc
        prof = by_kernel(kfn) if args.profile else None
        t_ops, t_bytes = flops / FP32_FLOP_S, nbytes / HBM_BYTES_S
        f32 = tol == 1e-4  # the bound counts float32 work (chip_smoke.py has the bf16 rows')
        emit(row=name, ms=ms, runs=runs, device_ms=prof, plain_ms=plain_ms,
             plain_runs=plain_runs, gemm_library_ms=gemm_ms, fft_library_ms=fft_ms,
             bound_ms=max(t_ops, t_bytes) * 1e3 if f32 else None,
             bound_by=("operations" if t_ops >= t_bytes else "bytes") if f32 else None,
             max_abs_err=err, scale=scale, checks=checks, digest=digest(got),
             bar=f"{tol:g} x max|plain|, rerun and the second element alone bit-equal")

    rows = args.rows.split(",")
    if "nmf_ref" in rows:
        x = torch.as_tensor(mixture(args.seed, 2, 10), device=dev)
        nmf_row("nmf_ref", mags(x), 128, 5)
    if "nmf_corpus" in rows:
        x = torch.as_tensor(mixture(args.seed + 1, 1, 81), device=dev)
        nmf_row("nmf_corpus", mags(x)[:, :20000].contiguous(), 256, 3)
    if "nmf_hour" in rows:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 5)
        src = torch.randn((3, 3600 * SR), generator=gen, device=dev) * 0.1
        right = sum(torch.roll(src[i], d) for i, d in enumerate(DELAYS))
        v = mags(torch.stack([src.sum(0), right])[None])
        del src, right
        nmf_row("nmf_hour", v, 128, 1)
        del v
        torch.cuda.empty_cache()
    if "nmf_edge" in rows:
        cap_row("nmf_edge", EDGE_ROWS)
    if "nmf_cap" in rows:
        cap_row("nmf_cap", CAP_ROWS)
    syn_rows = [r for r in rows if r in ("syn", "wiener", "syn16", "wiener16")]
    if syn_rows:
        b, k_, gain = 2, 128, HOP / WIN * 2.0
        x = torch.as_tensor(mixture(args.seed, b, 10), device=dev)
        spec = stft_ops.stft(x, window, HOP, conjugate=True)  # (B, 2, T, F)
        sre, sim = spec.real.contiguous(), spec.imag.contiguous()
        t = sre.shape[2]
        rng = np.random.default_rng(args.seed + 11)
        win_np = hann_symmetric(WIN)
        dft = 2.5 * WIN * math.log2(WIN)  # an FFT's flop a frame
        w = torch.as_tensor(rng.random((b, F, k_), dtype=np.float32) + 0.05, device=dev)
        h = torch.as_tensor(rng.random((b, 2, t, k_), dtype=np.float32) + 0.01, device=dev)
        winner = torch.as_tensor(rng.integers(0, 3, (b, t, k_)), dtype=torch.int32, device=dev)
        wd = torch.as_tensor(rng.random((F, k_), dtype=np.float32) + 1e-3, device=dev)
        h_mask = torch.as_tensor(rng.random((b, t, k_), dtype=np.float32), device=dev)
    for name in syn_rows:
        md = "float32" if name in ("syn", "wiener") else "bfloat16"
        tol = 1e-4 if md == "float32" else 1e-2
        if name.startswith("syn"):
            basis = synthesis_basis(win_np, gain, md, device=dev)
            kw = dict(num_targets=3, hop_size=HOP, matmul_dtype=md)
            synthesis_row(
                name, lambda: masked_synthesis_cuda(sre, sim, winner, w, h, basis, **kw),
                lambda: masked_synthesis_plain(sre, sim, winner, w, h, basis, **kw),
                lambda: masked_synthesis_cuda(sre[1:2].clone(), sim[1:2].clone(),
                                              winner[1:2].clone(), w[1:2].clone(),
                                              h[1:2].clone(), basis, **kw),
                b * 3 * 2 * t, 2 * b * 3 * 2 * t * F * k_ + b * 3 * 2 * t * dft,
                b * (2 * 2 * t * F * 4 + t * k_ * 4 + F * k_ * 4 + 2 * t * k_ * 4) + 4 * WIN
                + b * 3 * 2 * (t - 1) * HOP * 4, tol)
        else:
            basis = tf_synthesis_basis(wd, win_np, gain, md)
            kw = dict(hop_size=HOP, matmul_dtype=md)
            synthesis_row(
                name, lambda: tf_synthesis_cuda(sre, sim, h_mask, basis, **kw),
                lambda: tf_synthesis_plain(sre, sim, h_mask, basis, **kw),
                lambda: tf_synthesis_cuda(sre[1:2].clone(), sim[1:2].clone(),
                                          h_mask[1:2].clone(), basis, **kw),
                b * 2 * t, 2 * b * t * k_ * F + b * 2 * t * dft,
                b * 2 * 2 * t * F * 4 + b * t * k_ * 4 + k_ * F * 4 + 4 * WIN
                + b * 2 * (t - 1) * HOP * 4, tol)
    for name in [r for r in rows if r in ("frontend", "frontend16")]:
        from gccnmf_torch.ops.frontend_cuda import (
            frontend_basis, stft_gcc_frontend_cuda, stft_gcc_frontend_plain,
        )

        md = "float32" if name == "frontend" else "bfloat16"
        b, d_ = 2, 128
        x = torch.as_tensor(mixture(args.seed, b, 10), device=dev)
        cos_m, sin_m = (torch.as_tensor(m, device=dev)
                        for m in gcc.steering_cos_sin(float(SR), F, 1.0, d_))
        basis = frontend_basis(hann_symmetric(WIN), True, dev, md, (cos_m, sin_m))
        kw = dict(hop_size=HOP, matmul_dtype=md, plane_dtype=md)
        kfn = lambda: stft_gcc_frontend_cuda(x, basis, cos_m, sin_m, **kw)  # noqa: E731
        pfn = lambda: stft_gcc_frontend_plain(x, basis, cos_m, sin_m, **kw)  # noqa: E731
        got, again, want = kfn(), kfn(), pfn()
        one = stft_gcc_frontend_cuda(x[1:2].clone(), basis, cos_m, sin_m, **kw)
        t = got[5].shape[1]

        def rel(a, e):
            return float((a.double() - e.double()).abs().max()) / float(e.double().abs().max())

        extra, ref = {}, list(want)
        if md == "float32":  # the coherence against the function in float64
            frames = x.double().unfold(-1, WIN, HOP) * window.double()
            spec = torch.conj(torch.fft.rfft(frames, dim=-1))
            mag = spec.abs()
            coh = spec[:, 0] * torch.conj(spec[:, 1]) / (mag[:, 0] * mag[:, 1])
            ref[3:5] = coh.real, coh.imag
            extra = dict(coherence_vs_plain=max(rel(got[i], want[i]) for i in (3, 4)),
                         coherence_vs_float64=max(rel(got[i], ref[i]) for i in (3, 4)),
                         plain_coherence_vs_float64=max(rel(want[i], ref[i]) for i in (3, 4)),
                         spectrum_vs_float64=max(rel(g, e) for g, e in zip(
                             got[:3], (spec.real, spec.imag, mag))),
                         plain_spectrum_vs_float64=max(rel(w, e) for w, e in zip(
                             want[:3], (spec.real, spec.imag, mag))))
            del frames, spec, mag, coh
        tol = 1e-4 if md == "float32" else 8e-3
        err = max(rel(g, r) for g, r in zip(got, ref))
        checks = dict(rerun=all(torch.equal(g, a) for g, a in zip(got, again)),
                      alone=all(torch.equal(g[1:2], o) for g, o in zip(got, one)),
                      within_tol=err <= tol)
        if md == "float32":  # a parent's GEMM sits by the plain version, the FFT by float64
            err = max(max(rel(g, w) for g, w in zip(got[:3] + got[5:], want[:3] + want[5:])),
                      min(extra["coherence_vs_plain"], extra["coherence_vs_float64"]))
            checks["within_tol"] = err <= tol
        if not all(checks.values()):
            raise RuntimeError(f"{name}: {checks} (err {err} x max)")
        sha = digest(*got)
        del again, one, ref
        ms, runs = timed(kfn, 5)
        plain_ms, plain_runs = timed(pfn, 5)
        gemm_ms = fft_ms = None
        if md == "float32":  # the float32 row's yardsticks
            fr = torch.rand((b * 2 * t, WIN), device=dev)
            wb = torch.cat([basis.wcos, basis.wsin], dim=1)
            co = torch.rand((b * t, 2 * F), device=dev)
            st = torch.cat([cos_m, sin_m])
            gemm_ms, _ = timed(lambda: (fr @ wb, co @ st), 5)
            fft_ms, _ = timed(lambda: (torch.fft.rfft(fr * window, dim=-1), co @ st), 5)
            del fr, wb, co, st
        prof = by_kernel(kfn) if args.profile else None
        flops = b * 2 * t * 2.5 * WIN * math.log2(WIN) + 4 * b * t * F * d_
        nbytes = (b * 2 * x.shape[-1] * 4 + 4 * (WIN + 2 * F * d_) + b * 4 * 8 * t * F
                  + b * t * d_ * 4)
        t_ops, t_bytes = flops / FP32_FLOP_S, nbytes / HBM_BYTES_S
        emit(row=name, shape=dict(B=b, T=t, F=F, D=d_, win=WIN, hop=HOP), ms=ms, runs=runs,
             device_ms=prof, plain_ms=plain_ms, plain_runs=plain_runs, gemm_library_ms=gemm_ms,
             fft_library_ms=fft_ms,
             bound_ms=max(t_ops, t_bytes) * 1e3 if md == "float32" else None,
             bound_by=("operations" if t_ops >= t_bytes else "bytes") if md == "float32"
             else None, max_rel_err=err, checks=checks, digest=sha,
             bar=(f"{tol:g} x max|plain| (float32: the coherence x max of the plain version or of "
                  "float64, the nearer), rerun and "
                  "the second element alone bit-equal"), **extra)
        del got, want
        torch.cuda.empty_cache()
    if "paths" in rows:
        from gccnmf_torch.models.offline import GCCNMFEnhancer, GCCNMFSeparator, OfflineConfig

        mix0 = mixture(args.seed, 1, 10)[0]
        w_e = np.random.default_rng(args.seed + 13).random((F, 128), dtype=np.float32) + 0.05
        sep = GCCNMFSeparator(OfflineConfig(nmf_matmul_dtype="float32"))
        enh = GCCNMFEnhancer(w_e, OfflineConfig(mic_separation_m=0.1, num_tdoas=128,
                                                dictionary_size=128,
                                                nmf_matmul_dtype="float32"))

        def wall(fn):
            fn()
            torch.cuda.synchronize()
            out = []
            for _ in range(5):
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(out), out

        sep_ms, sep_runs = wall(lambda: sep.separate(mix0))
        enh_ms, enh_runs = wall(lambda: enh.enhance(mix0))
        emit(row="paths", separate_float32_ms=sep_ms, separate_runs=sep_runs,
             separate_audio_s_per_s=10e3 / sep_ms, enhance_float32_ms=enh_ms,
             enhance_runs=enh_runs, enhance_audio_s_per_s=10e3 / enh_ms)
        del sep, enh
    if "mask" in rows:
        d_, k_, b = 128, 128, 2
        x = torch.as_tensor(mixture(args.seed, b, 10), device=dev)
        spec = stft_ops.stft(x, window, HOP, conjugate=True)
        coh = gcc.coherence(spec, guard_zeros=True)  # (B, T, F)
        cre, cim = coh.real.contiguous(), coh.imag.contiguous()
        cre[1, 5] = float("nan")
        t = cre.shape[1]
        cos_m, sin_m = (torch.as_tensor(m, device=dev)
                        for m in gcc.steering_cos_sin(float(SR), F, 0.1, d_))
        rng = np.random.default_rng(args.seed + 7)
        w = torch.as_tensor(rng.random((F, k_), dtype=np.float32) + 0.05, device=dev)
        basis = soft_mask_basis(cos_m, sin_m, w, "float32")
        ang = gcc.angular_spectrogram(torch.complex(torch.nan_to_num(cre), cim), cos_m, sin_m)
        tgt = torch.argmax(gcc.mean_angular_spectrum(ang), dim=-1)
        margs = (cre, cim, basis, tgt, 5.0, 2.0, 0.0)
        got, arg = soft_mask_cuda(*margs, matmul_dtype="float32", return_argmax=True)
        again, arg2 = soft_mask_cuda(*margs, matmul_dtype="float32", return_argmax=True)
        one = soft_mask_cuda(cre[1:2].clone(), cim[1:2].clone(), basis, tgt[1:2], 5.0, 2.0, 0.0,
                             matmul_dtype="float32")
        want = soft_mask_plain(*margs, matmul_dtype="float32")
        flipped, gap, scale = argmax_flips(cre, cim, basis, arg, matmul_dtype="float32")
        ulps = int((got.view(torch.int32).long() - want.view(torch.int32).long())
                   .abs()[~flipped].max())
        checks = dict(rerun=bool(torch.equal(got, again) and torch.equal(arg, arg2)),
                      alone=bool(torch.equal(got[1:2], one)),
                      nan_frame_tdoa0=bool((arg[1, 5] == 0).all()),
                      flip_gap_ok=gap <= 1e-5 * scale, ulps_ok=ulps <= 2)
        if not all(checks.values()):
            raise RuntimeError(f"mask: {checks} (gap {gap}, scale {scale}, ulps {ulps})")
        ms, runs = timed(lambda: soft_mask_cuda(*margs, matmul_dtype="float32"), 5)
        plain_ms, plain_runs = timed(lambda: soft_mask_plain(*margs, matmul_dtype="float32"), 5)
        rows_ = torch.cat([cre, cim], dim=-1).reshape(b * t, 2 * F)
        fold = torch.cat([basis.cw, basis.sw], dim=1).permute(1, 0, 2).reshape(2 * F, d_ * k_)
        lib_ms, _ = timed(lambda: rows_ @ fold, 5)
        least = 2 * b * t * F * d_ * k_ + 3 * b * t * F * d_
        jax_fn = 4 * b * t * F * d_ * k_
        nbytes = b * 2 * t * F * 4 + 4 * (F * k_ + 2 * F * d_) + b * 16 + b * t * k_ * 4
        prof = (by_kernel(lambda: soft_mask_cuda(*margs, matmul_dtype="float32"))
                if args.profile else None)
        emit(row="mask", shape=dict(B=b, T=t, F=F, K=k_, D=d_), ms=ms, runs=runs,
             device_ms=prof,
             tflop_s=jax_fn / ms / 1e9, plain_ms=plain_ms, plain_runs=plain_runs,
             gemm_library_ms=lib_ms,
             bound_ms=max(least / FP32_FLOP_S, nbytes / HBM_BYTES_S) * 1e3,
             bound_by="operations", function_floor_ms=jax_fn / FP32_FLOP_S * 1e3,
             max_abs_err=float((got - want).abs().max()), argmax_flips=int(flipped.sum()),
             flip_gap=gap, scale=scale, mask_ulps=ulps, checks=checks,
             bar="argmax flips only at near-ties (1e-5 x max), masks within 2 ulps elsewhere")
    return 0


if __name__ == "__main__":
    sys.exit(main())
