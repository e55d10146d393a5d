#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gccnmf_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``. It
needs one card and a CUDA toolkit (``nvcc``), and imports nothing of JAX or
of ``gccnmf_tpu``. Phases, one JSON line each:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; asserts TF32 is off for matmuls and cuDNN.
2. ``build``: builds every kernel under ``gccnmf_torch/csrc`` with ``nvcc``,
   and reads the library's SASS with ``cuobjdump -sass`` from the same
   toolkit: each tensor-core kernel (the NMF's three materialised-Q
   products and its two on-chip ones, the soft mask's
   scores, the iDFT of ``istft.cuh`` in both sources that include it, and
   the front-end's rDFT and angular products) must hold HGMMA (``wgmma``)
   instructions in each source that instantiates it, and so must each of
   its instantiations (the NMF ratio's, which the turbo mode launches
   too); their ptxas registers and spills are printed, by source, and the
   iDFT, the front-end's and the soft mask's scores must not spill. ptxas's
   numbered performance notes on them are printed too (``ptxas_notes``),
   and the soft mask's scores, which keep one ``wgmma`` group in flight
   across their slices, must have none that waits for or serialises their
   ``wgmma``s (C7514, C7517, C7518). The float32 products on the
   pipelined SIMT core of ``simt_gemm.cuh`` (the NMF's three, the soft
   mask's scores), the float32 iDFT's FFT (``fft_frames_kernel`` of
   ``istft.cuh``, in both sources) and the front-end's float32 rDFT on
   the same FFT passes (``fft_coherence_kernel`` of ``frontend.cu``) must
   hold no tensor-core instruction
   (HGMMA or HMMA: exact fp32, no TF32) and must not spill; their
   registers and spills are printed too.
3. ``kernel``: each kernel and mode at the reference shapes (batch 2, a 10 s
   16 kHz stereo mixture made from ``--seed``) against its plain PyTorch
   version on the card, twice (bit-identical), with CUDA-event times of
   kernel and plain version and the card's bound for the same work; then
   the default config's modes and the turbo NMF (``bfloat16_q_simul``)
   again at batch 16, the NMF at its full 100 iterations, which are the
   shapes ``separate_batch`` gives them. Each NMF row names its product
   design (``wgmma_q_on_chip`` in ``bfloat16`` and ``bfloat16_q``: Q kept
   on chip, ``nmf_cuda.q_on_chip``; ``wgmma`` in turbo, Q materialised;
   ``simt2`` in float32: the pipelined core of ``simt_gemm.cuh``) and
   carries
   ``gemm_library_ms``: the same iteration's products (four; three in the
   turbo mode) as ``torch.matmul`` calls at the row's batch and operand
   type, times 100 (a yardstick only; the port never calls it). Each front-end
   row names its design too (``wgmma`` in bf16, ``fft`` in float32: the
   hand-written FFT of ``frontend.cu`` on the passes of ``fft.cuh``) and
   carries ``gemm_library_ms``: the rDFT as one ``torch.matmul`` of the
   (B·2·T, win) frames against the (win, 2F) basis plus the angular
   spectrogram as one of the (B·T, 2F) coherence rows against the (2F, D)
   steering planes, in the row's operand type and batch (a yardstick only),
   in float32 also ``fft_library_ms`` (the frames times the window through
   ``torch.fft.rfft`` plus the same angular ``torch.matmul``), and
   ``device_ms``: its kernels' device time in one call (torch.profiler),
   which the CUDA-event ``ms`` exceeds by the wrapper's host time, with
   ``device_ms_by_kernel``. In float32 the coherence planes are held
   against the front-end's function in float64 (the float64 rfft of the
   windowed frames) at the same 1e-4 × max bar, since near a bin of tiny
   |X| the plain version's fp32 GEMM is itself farther than the bar from
   it; the row gives the kernel's and the plain version's distances
   (``coherence_vs_plain``, ``coherence_vs_float64``,
   ``plain_coherence_vs_float64``, and the same for the spectrum).
   The enhancement kernels (soft mask, Wiener synthesis) are held the same
   way on the enhancement configuration of ``bench.py`` (10 cm spacing,
   128 TDOAs, K = 128), with a dictionary learned by the NMF kernel
   (float32, 100 iterations) on the first mixture's |X|. Each soft-mask row
   names its design too and carries ``gemm_library_ms``: the same scores as
   one ``torch.matmul`` of the ``[Re c | Im c]`` rows against the (2F, D·K)
   fold, in the row's operand type and batch (a yardstick only); its
   float32 design is ``simt2``, like the NMF's, its bf16 design
   ``wgmma_tma_cluster`` (``csrc/scores.cu``). Two more soft-mask rows run
   the bf16 scores at the enhancement cell's shape (60 s, 64 TDOAs, K =
   1,024, seeded planes): two mixtures against the plain version at the
   same bars, and equal bit for bit to the first two of the cell's 16,
   whose call is timed, with its mask's SHA-256 and the counts of
   ``soft_mask_cuda``'s calls and of those that took the cluster route
   (``launches``, ``multicast``: equal). The
   synthesis rows (masked and Wiener) name their iDFT design (``wgmma`` in
   bf16, ``fft`` in float32: the hand-written FFT of ``istft.cuh``) and
   carry ``gemm_library_ms``: the iDFT alone as one ``torch.matmul`` of the
   (Z·T, 2F) spectrum rows against the (2F, win) basis, in the row's
   operand type and batch; the float32 rows also ``fft_library_ms``: the
   same rows as ``torch.fft.irfft`` times the window (yardsticks only).
4. ``separate``: the default ``GCCNMFSeparator()`` (``bfloat16_q``) through
   ``separate`` (3 sources) and ``separate_batch`` (16 utterances), each
   timed as the median of 5 calls after a warm-up, with the kernels' launch
   counters set to 0 just before each call and read just after it; every
   utterance of the batch is held against ``separate`` of it alone.
   ``mode``: the same ``separate`` with ``nmf_matmul_dtype="bfloat16"``.
   ``turbo``: ``separate`` and ``separate_batch`` with
   ``nmf_matmul_dtype="bfloat16_q_simul"``, timed and counted the same way,
   every utterance of the batch held against ``separate`` of it alone, the
   targets those of ``bfloat16_q``. ``throughput``: ``separate_batch``
   with ``num_sources=None`` (source counting on the device: counts,
   silent pads, the count op against its CPU run on the same spectra), and
   ``separate_batches`` over 4 chunks of 16 in float32 and int16 I/O (the
   int16 program fed 16-bit PCM) beside the same chunks through
   ``separate_batch`` one after another, each chunk held against
   ``separate_batch``, with audio-s/s of both. ``cli``:
   ``gccnmf_torch.cli.separate_main`` on a WAV of the first mixture with
   ``--turbo --auto-sources``, its outputs read back.
5. ``parity``: float32 mode, all kernels against the plain torch path on the
   card: equal targets and > 25 dB SNR per target.
6. ``enhance``: the default-mode ``GCCNMFEnhancer`` through ``enhance`` of
   one mixture and of the batch of 16, counted per path like ``separate``,
   every utterance of the batch held against ``enhance`` of it alone; then
   ``num_h_updates=2`` once, which runs the front-end kernel alone and the
   rest as torch ops, as the JAX enhancer leaves its fused kernels there.
   ``tdoa_split``: the soft mask and ``enhance`` of one mixture with the
   soft mask's TDOAs split across blocks and unsplit. ``enhance_parity``: float32 mode, the kernels
   against the plain torch path on the card, with and without H updates.
7. ``profile``: one default ``separate_batch``, one chunk of 16 through
   ``separate_batches`` and one default batched ``enhance`` under
   ``torch.profiler``: device time by stage (the NMF's three products apart
   from its small launches, the host-device copies apart), the top kernels,
   and the device's idle share.

8. ``stream``: ``RTGCCNMFProcessor`` at the default ``GCCNMFConfig`` (window
   1024, hop and block 512, 64 TDOAs at 0.1 m, K = 64, history 128) with a
   dictionary that the NMF kernel learns (float32, 100 iterations) on |X| of
   the first mixture; the audio is made from ``--seed + 1`` and rounded to
   16-bit PCM. ``enhance_signal`` of 10 s at B = 1 in three configurations
   (default, ``num_h_updates=2``, the low-latency asymmetric windows at hop
   and block 128, synthesis 256) and at B = 64, each the median of 3 calls
   after a warm-up that captures the graph; the ``stream --realtime`` command
   (the host loop, per-block p50/p99 against the 32 ms deadline). Checks:
   the graph replay equals the eager step on the card block by block (40
   blocks, 1e-6 x max, equal targets), the card meets the CPU tests' oracle
   bars against the port's CPU path (SNR > 25 dB, > 0.93 of samples within
   3e-4 x max), each of the 64 batch elements equals its stream alone
   (1e-5), and no kernel wrapper launched. Then a profile of one B = 1 call.
9. ``serve``: ``StreamServer`` with 64 slots and 64 open streams, 300 ticks
   of the seeded blocks: ``pipeline_depth=2`` with async fetch on the
   float32 wire and on the int16 wire, then one stream of one slot with
   synchronous ticks; ``tick_stats()`` of each (tick and delivery p50/p99,
   deadline misses) and the aggregate realtime factor. Every served stream
   equals the same blocks through a B = 1 processor (1e-5), the int16 wire
   the clipped float32 output within one PCM step. Then a profile of 20
   ticks. Neither phase launches any of the five kernels.
10. ``pretrain``: 64 seeded 10 s 16 kHz stereo WAVs (``make_mixture``,
    ``--seed + 2``, 39,808 frames, cut to the default 20,000) through
    ``cli.pretrain_main`` with ``--sizes 64 128 256``, the default window,
    hop and 100 iterations: each size's seconds and its launches (none:
    pretraining runs JAX's unguarded plain updates, trained or from the
    cache), the cache files named by the in-process corpus's fingerprint,
    each W equal to one plain ``kl_nmf`` call from the seeded init; kernel
    1 (float32) at each size within rtol 1e-4 of the plain version after 15
    iterations and within 0.5 % of its KL at 100 (one CUDA-event time of
    each 100-iteration call per size); ``checkpoint.kl_nmf_checkpointed``
    (100 iterations in chunks of 25, and resumed from iteration 50)
    bit-equal to one plain call, no launch; the kernel row of kernel 1 at
    the corpus shape (B = 1, T = 20,000, K = 256); and
    ``get_dictionaries``' larger sizes (K = 512, 1,024) within rtol 1e-4 of
    the plain version after 15 iterations on the same corpus.
11. ``online``: ``OnlineGCCNMFEnhancer`` with the pretrained W_64 and the
    default ``OnlineConfig`` (sliding, window 1024, hop 512, 64 TDOAs) on
    10 s of the WAVs at B = 1 and 16, and with exponential and cumulative
    smoothing and ``num_h_updates=2`` at B = 1, each the median of 5 calls
    after a warm-up; each batch element within 1e-5 x max of itself alone,
    each configuration against the CPU (> 25 dB, targets equal on >= 99 %
    of frames), no kernel launched; then a profile of the B = 16 call.
12. ``enhance_cli``: ``cli.enhance_main`` over 16 of the WAVs in one call,
    ``--mode online`` and ``--mode offline`` with ``--dictionary-file
    W_64.npy``: each output equal to the in-process enhancer's as the WAV
    writer stores it; offline, the front-end, soft-mask and Wiener-synthesis
    kernels launched once a file, the same command on the CPU matched
    (> 45 dB per channel), and each of the three kernels held against its
    plain version at the command's shapes (window 1024, hop 512, 64 TDOAs,
    K = 64, B = 1: rows ``...@B1,hop512,D64,K64``) as in ``kernel``; then
    ``stream`` without ``--dictionary-file`` trains W into the cache and
    finds it there unchanged, no launch either time.
13. ``long_audio``: ``LongAudioSeparator`` on the card. Parity on a 60 s
    int16 WAV (``--seed + 3``) with ``chunk_frames=1024`` (the last chunk
    ragged): ``separate_streamed`` in float32 within 3/32768 of the card's
    ``GCCNMFSeparator`` (the kernels' float32 path), the one-shard
    ``separate`` above 40 dB against it, the default mode (bf16 planes)
    above 20 dB against it, all with the mixture's three targets; a 10 s
    file at the default config streamed on the card and on the CPU, the
    same targets and >= 40 dB per output; one launch of kernel 1 (float32:
    the one-device exact NMF) in each of the four card runs, no other
    kernel. Then one hour (``--seed + 5``, 449,993 frames, 899,986 NMF rows)
    through ``separate_streamed`` at ``OfflineConfig()`` and chunks of
    8,192 frames: wall seconds, audio-s/s, the stage seconds and transfer
    MB, the peak of ``torch.cuda.max_memory_allocated`` and the host's
    memory before, after and at its peak (sampled every 20 ms): its
    anonymous part (``RssAnon``, or where ``/proc`` has none ``VmData``
    less the input's copy-on-write memory map) may grow by at most twice
    one chunk's host buffers; the three
    targets, every output the expected length and nonzero, one launch of
    kernel 1 and no other. Last, kernel 1 (float32) at the hour's NMF shape
    (B = 1, T = 899,986, K = 128), which the path runs, against the guarded
    plain ``kl_nmf`` that it replaced there, rtol 1e-4 after 15
    iterations, both timed once at 100 after a warm-up, and its
    ``gemm_library_ms``: one iteration's four float32 products as
    ``torch.matmul`` at that shape, times 100. ``nmf_row_cap``: kernel 1
    (float32) on V of 4,194,304 rows (F = 33, K = 8, about 0.55 GB), past
    the 4,194,240 rows whose H update fits one grid (CUDA caps gridDim.y
    at 65,535), against the plain updates after 3 iterations (rtol 1e-4,
    atol 1e-6 x max), the kernel timed once at 3.
14. ``distributed``: the process groups (``gccnmf_torch/parallel``) in a
    world of one over NCCL in this process, one line per check: (e)
    ``init_process_group`` on a ``file://`` store, timed, one
    ``all_reduce`` and one ``all_gather`` of CUDA tensors, the (1, 1) mesh;
    (a) ``kl_nmf_sharded`` on V of a 60 s mixture (``--seed + 6``, 14,986
    rows, F = 513, K = 128, 100 iterations) against ``nmf.kl_nmf``
    unguarded and with ``guard=True``, and with ``simultaneous=True``
    against ``kl_nmf_simul``, W and H within 1e-5 x max, both timed; (b)
    ``DistributedNMFTrainer`` on a seeded 20,000 x 513 corpus, K = 256,
    100 iterations, checkpoints every 50, against ``pretrain.corpus_nmf``
    (1e-5 x max, seconds of both), and a fresh trainer resumed from the
    iteration-50 checkpoint against the uninterrupted W; (c)
    ``LongAudioSeparator(mesh=...).separate`` of 10 minutes (``--seed +
    8``) at ``OfflineConfig()`` against the mesh-less ``separate`` on the
    same plain guarded updates (the mesh's NMF is JAX's plain
    ``kl_nmf_sharded``): the mixture's targets in both, W within 1e-5 x
    max, every target above 40 dB, audio-s/s and ``max_memory_allocated``
    of each, run in turns (mesh, mesh-less, mesh-less, mesh); no kernel
    launched in (a)-(c); then the mesh-less ``separate`` as users run it
    (kernel 1 float32 for its NMF, one launch) against that reference:
    the same targets, every target above 40 dB. Then (d) the commands as subprocesses: ``separate
    --time-shards 1 --streamed`` (rc 0, its JSON, the targets), ``separate
    --time-shards 2`` on this one card (non-zero, make_mesh's "exceeds"
    error, nothing written), and ``pretrain --data-shards 1 --sizes 64``
    over 4 seeded WAVs against ``pretrain --sizes 64`` (W within 1e-5 x
    max).
15. ``realtime``: the realtime app (``gccnmf_torch/realtime``) at the stream
    phase's configuration (``GCCNMFConfig()``, hop and block 512, 64 TDOAs
    at 0.1 m, K = 64), with its dictionary as ``W_64.npy`` and its first
    10 s mixture as a WAV, one line per check. ``native``: the host
    runtime's library rebuilt with g++ (seconds) and loaded, and every
    function of ``gccnmf_torch/native`` through it bit-equal to its NumPy
    path on seeded arrays (the SPSC ring across many wraps; the block-time
    mean within 1e-12 relative). ``app``: ``RealtimeGCCNMF().run(-o)`` on
    the card within 1e-6 x max of ``RTGCCNMFProcessor.enhance_signal`` of
    the same signal on the card, the card against the same app on the CPU
    at the stream phase's bars (> 25 dB, > 0.93 of samples within 3e-4 x
    max), the ``pipeline_depth=2`` file byte-identical to depth 0, the
    histories after the run equal to the eager step's telemetry block by
    block on the card (1e-6 x max, the targets exactly), per-block p50/p99
    at depth 0 and 2, and the warm app's audio-s/s unpaced against
    ``enhance_signal`` at B = 1 (median of 3 each). ``command``:
    ``cli.main(["realtime", ...])`` with ``--realtime-pace --blocks 94``
    (p99 under the 32 ms deadline) and unpaced over the whole file.
    ``storm``: 300 blocks on the audio thread while a second thread calls
    ``set_target_window`` and reads ``histories`` (at least once a block)
    and fires ``set_dictionary`` to K = 128 and back, ``set_num_tdoas``,
    ``set_mic_separation``, ``set_num_h_updates(2)``, ``set_target_mode``
    and ``set_block_geometry(hop_size=256)``: no exception, finite outputs,
    every value the GUI reads a host value; the build-and-capture ms of
    each rebuild and ``memory_allocated`` after each, then twenty rebuilds
    of one configuration (``memory_allocated`` after the last within 1 MiB
    of after the first). No kernel launches in the phase.
16. ``serve_mesh``: the serve phase's configuration (64 slots, 64 streams,
    300 ticks, ``pipeline_depth=2``, async fetch) through
    ``StreamServer(mesh=local_mesh(1))`` and ``mesh=local_mesh(2,
    devices=["cuda:0", "cuda:0"])`` (two shards on this card, each its
    own graph, replayed in turn on the card's stream) beside the unsharded server, in turns
    (unsharded, mesh 1, mesh 2, mesh 2, mesh 1, unsharded) on the float32
    wire, then both meshes on the int16 wire: every stream within 1e-5 of
    the first unsharded run, the int16 wire within one PCM step of its
    clipped float32 output, the same telemetry targets, no kernel launched,
    and ``local_mesh(2)`` with the default devices raising "exceeds" on a
    one-card machine; ``tick_stats()`` of each run.
17. ``conv_stft``: ``stft`` and ``istft`` with ``method="conv"`` (cuDNN,
    TF32 off) against ``method="fft"`` on the first mixture, within 2e-4 x
    max and 5e-5 x max (the JAX suite's bars), CUDA-event times of each;
    then ``GCCNMFSeparator`` in float32 on the plain backends (on the card
    the front-end and synthesis kernels take the STFT's place) with
    ``stft_method="conv"`` against ``"fft"``: equal targets, > 25 dB per
    target, the seconds of each in turns; no kernel launched.
18. ``metrics``: ``bss_eval_sources``, ``si_sdr``, ``stoi`` and ``pesq`` of
    the ``separate`` phase's three estimates of the first mixture against
    its seeded sources' images at the two mics from sample ``WIN // 2`` on,
    where the ISTFT's center trim starts them (the estimates matched to
    the sources by ``bss_eval_sources``' permutation): the scores and the
    seconds each takes on the host; every score finite, PESQ (the
    P.862.2 MOS-LQO of a raw score in [-0.5, 4.5]) in [0.999, 4.65].
19. ``stamp``: ``run_stamp(config_fingerprint(OfflineConfig()))`` here
    (``torch.cuda.is_initialized()`` unchanged by the call) and in a fresh
    process (no CUDA context created), the same keys and fingerprint.

Then the kernels line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the kernel table's yardstick: the benchmark's own arithmetic (peak rates of
# one H100 SXM at its 700 W limit), so that the table and the cells count
# the same work
from portbench.harness.roofline import PEAK_FLOP_S, basis_len, bound, dft_flops  # noqa: E402

SR, SECONDS, WIN, HOP, K, D, SOURCES = 16000, 10, 1024, 128, 128, 128, 3
# the mixture's delays (samples) of the right mic behind the left, per source
DELAYS = (8, -11, 3)
KERNEL_BATCH, MAIN_BATCH, NMF_CHECK_ITERS, NMF_ITERS = 2, 16, 15, 100
# separate_batches runs CHUNKS chunks of MAIN_BATCH; the device source count
# keeps up to AUTO_MAX sources
CHUNKS, AUTO_MAX = 4, 4
# separate_batch(mix)[i] against separate(mix[i]), max |diff| over max
# |separate|: the same kernels at B = 16 and B = 1 (the NMF's split sums
# depend on T only), and the attribution GEMM runs one utterance at a time
# (a batched cuBLAS product once flipped an argmax at a near-tie), so on an
# H100 the two read bit-equal. The enhancer's batch is held to the same
# bar.
BATCH_TOL = 1e-5
# the enhancement configuration of bench.py's enhancement bench: 10 cm
# spacing, 128 TDOAs, K = 128, and the enhancer's default mask parameters
ENH_MIC_M, ENH_EPS, ENH_BETA, ENH_FLOOR = 0.1, 5.0, 2.0, 0.0
# soft mask: an argmax may flip where two TDOAs score within rounding of
# each other; the plain score at the kernel's TDOA must lie within
# TIE_TOL x max|plain maximum| of the plain maximum, the masks must agree
# within MASK_ULPS fp32 ulps wherever the argmax agrees, and the masks
# must agree (argmax flips included) on these shares of (t, k)
TIE_TOL = 1e-5
MASK_ULPS = 2
MASK_AGREE = {"float32": 0.999, "bfloat16": 0.99}
# each main path's wall time is the median of this many calls after a
# warm-up: a single call of `separate` varied by a third between runs
TIMED_CALLS = 5
# streaming and serving: B of the batched enhance_signal and the server's
# slots (all tenanted), the server's ticks, the blocks held graph against
# eager, and the timed calls of each enhance_signal
STREAM_BATCH = SERVE_SLOTS = 64
SERVE_TICKS, REPLAY_BLOCKS, STREAM_CALLS = 300, 40, 3
# pretraining: the WAVs of the corpus (2 × 311 frames each), the sizes the
# command trains, and the frames the default cap keeps
PRETRAIN_WAVS, PRETRAIN_SIZES, PRETRAIN_FRAMES = 64, (64, 128, 256), 20000
# long audio: the parity file's seconds and macro-chunk width (its last
# chunk ragged), and the seconds of the hour-long file
LONG_PARITY_S, LONG_CHUNK, HOUR_S = 60, 1024, 3600
# kernel 1 float32 past CUDA's 65,535 cap on gridDim.y: 65,536 row tiles of
# 64 in the H update, one more than one grid holds (4.66 h of audio)
ROW_CAP_ROWS = 4_194_304
# process groups: the seconds of the 60 s mixture whose V the sharded NMF
# runs on, the trainer's dictionary size, the sharded separator's seconds of
# audio, and the bar of each against its one-device run (x max)
DIST_NMF_S, DIST_TRAIN_K, DIST_SEP_S, DIST_TOL = 60, 256, 600, 1e-5
# the enhance command on the card against the same command on the CPU, the
# least SNR (dB) of any output channel: 49.39 dB measured on an H100
CLI_SNR_DB = 45.0
# the streaming step's device time by stage, for the profiler
STREAM_STAGES = {"cuFFT": ("fft", "FFT"), "GEMMs (cuBLAS)": ("gemm", "gemv"),
                 "H2D copies": ("Memcpy HtoD",), "D2H copies": ("Memcpy DtoH",)}
# how dft_flops counts a mode's DFTs, for the kernel table: in float32 an
# FFT computes the same function; in the bf16 modes the JAX package rounds
# the windowed DFT basis to bf16, which no FFT reproduces, so the least work
# under its rounding points is the GEMM against the basis
DFT_COUNTED = {True: "DFTs as FFTs (2.5·N·log2 N)",
               False: "DFTs as GEMMs on the bf16-rounded basis"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_sources(seed: int, batch: int, seconds: int = SECONDS) -> np.ndarray:
    """(batch, SOURCES, n) float32: the white-noise sources at 0.1 RMS of
    :func:`make_mixture` with the same arguments."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, SOURCES, SR * seconds), dtype=np.float32) * 0.1


def make_mixture(seed: int, batch: int, seconds: int = SECONDS) -> np.ndarray:
    """(batch, 2, n) float32: three white-noise sources at 0.1 RMS, delayed
    by DELAYS samples between the mics (as bench.py's synthetic fallback
    does with two)."""
    src = make_sources(seed, batch, seconds)
    right = sum(np.roll(src[:, i], d, axis=-1) for i, d in enumerate(DELAYS))
    return np.stack([src.sum(axis=1), right], axis=1).astype(np.float32)


def host_memory_mib() -> dict[str, float]:
    """This process's host memory in MiB from ``/proc/self/status``:
    ``RssAnon`` (anonymous resident pages) where the kernel reports it,
    ``VmData`` (private data mappings: anonymous memory, resident or not)
    and ``VmRSS`` (every resident page, a memory-mapped input's included)."""
    out = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key = line.split(":", 1)[0]
            if key in ("RssAnon", "VmData", "VmRSS"):
                out[key] = int(line.split()[1]) / 1024.0
    return out


def delay_targets(gcc) -> list[int]:
    """The TDOA indexes of the mixture's DELAYS on the default grid (128
    TDOAs over ±1 m / c): the nearest grid point to each delay, negated,
    since the right channel lags by d."""
    grid = gcc.tdoa_grid(1.0, D) * SR
    return sorted(int(np.argmin(np.abs(grid + d))) for d in DELAYS)


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


# the tensor-core kernels whose SASS must hold HGMMA, with the sources that
# instantiate each: the NMF's three materialised-Q products and its two
# on-chip back-to-back products (csrc/nmf.cu), the soft mask's
# scores (csrc/scores.cu), the iDFT of csrc/istft.cuh, which both
# syntheses include (csrc/synthesis.cu, csrc/enhance.cu), and the
# front-end's rDFT and angular products (csrc/frontend.cu)
TC_KERNELS = {"tc_wh_ratio_kernel": ("nmf.cu",), "tc_h_update_kernel": ("nmf.cu",),
              "tc_qth_split_kernel": ("nmf.cu",), "fused_h_update_kernel": ("nmf.cu",),
              "fused_qth_split_kernel": ("nmf.cu",), "tma_score_argmax_kernel": ("scores.cu",),
              "tc_frames_kernel": ("synthesis.cu", "enhance.cu"),
              "tc_dft_coherence_kernel": ("frontend.cu",), "tc_angular_kernel": ("frontend.cu",)}
# substrings of the front-end's kernel names, for the profiler
FRONTEND_KERNELS = ("dft_signal_rows", "dft_frame_rows", "dft_coherence", "fft_coherence",
                    "angular_kernel")
# the tensor-core kernels that must not spill: two blocks an SM leave each
# thread 128 registers; the soft mask's scores hand the producer's registers
# to the consumers (setmaxnreg: 232 a consumer thread)
NO_SPILL = ("tc_frames_kernel", "tc_dft_coherence_kernel", "tc_angular_kernel",
            "tma_score_argmax_kernel")
# the tensor-core kernels that keep one wgmma group in flight across their
# slices (wgmma_wait<1>), on which ptxas may add no wait and serialise
# nothing (no C7514, C7517 or C7518 note)
PIPELINED = ("tma_score_argmax_kernel",)
# the products on the pipelined SIMT core (csrc/simt_gemm.cuh), the float32
# iDFT's FFT (csrc/istft.cuh) and the front-end's float32 rDFT on the same
# FFT passes (csrc/fft.cuh), by the sources that instantiate each: exact
# fp32 sums, so their SASS must hold no tensor-core instruction (HGMMA, or
# HMMA as TF32 would use), and they must not spill. Matched by the name's
# mangled form (its length, then the name): angular_kernel is a substring
# of the tensor-core tc_angular_kernel, spectra_kernel of
# wiener_spectra_kernel
SIMT_KERNELS = {"simt_wh_ratio_kernel": ("nmf.cu",), "simt_h_update_kernel": ("nmf.cu",),
                "simt_qth_split_kernel": ("nmf.cu",),
                "simt_score_argmax_kernel": ("enhance.cu",),
                "wiener_spectra_kernel": ("enhance.cu",), "spectra_kernel": ("synthesis.cu",),
                "angular_kernel": ("frontend.cu",),
                "fft_frames_kernel": ("synthesis.cu", "enhance.cu"),
                "fft_coherence_kernel": ("frontend.cu",)}
# a kernel name that tells a source's SASS apart from the others', tried in
# this order (synthesis.cu's spectra_kernel is also a substring of
# enhance.cu's wiener_spectra_kernel)
SOURCE_MARKERS = {"scores.cu": "tma_score_argmax_kernel",
                  "enhance.cu": "simt_score_argmax_kernel", "nmf.cu": "tc_h_update_kernel",
                  "frontend.cu": "angular_kernel", "synthesis.cu": "spectra_kernel"}


def hgmma_counts(nvcc: str, library: str) -> tuple[dict[str, int], list[str], dict[str, int]]:
    """HGMMA instructions per tensor-core kernel and source (``"kernel
    (source)"``, all instantiations together) in the SASS of ``library``,
    read with the ``cuobjdump`` of ``nvcc``'s toolkit: each source's
    object keeps its own ELF in the library, named by its marker kernel.
    Also the instantiations (mangled names) that hold none, such as a
    ``tc_wh_ratio_kernel<TV, 2>`` that the turbo mode launches, and the
    tensor-core instructions (HGMMA and HMMA) of each SIMT kernel."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {f"{k} ({src})": 0 for k, srcs in TC_KERNELS.items() for src in srcs}
    simt = {f"{k} ({src})": 0 for k, srcs in SIMT_KERNELS.items() for src in srcs}
    empty = []
    for elf in sass.split("Fatbin elf code")[1:]:
        src = next((s for s, marker in SOURCE_MARKERS.items() if marker in elf), "?")
        for section in elf.split("Function : ")[1:]:
            name = section.split("\n", 1)[0]
            for k in TC_KERNELS:
                if k in name:
                    key = f"{k} ({src})"
                    counts[key] = counts.get(key, 0) + section.count("HGMMA")
                    if "HGMMA" not in section:
                        empty.append(f"{name.strip()} ({src})")
            for k in SIMT_KERNELS:
                if f"{len(k)}{k}" in name:
                    key = f"{k} ({src})"
                    simt[key] = simt.get(key, 0) + section.count("HGMMA") + section.count("HMMA")
    return counts, empty, simt


def ptxas_summary(build_log: str) -> dict[str, str]:
    """Registers and spills that ``ptxas -v`` reported for each
    instantiation of the tensor-core and SIMT product kernels, by source
    (the build log's ``== <source>`` lines)."""
    lines, out, src = build_log.splitlines(), {}, "?"
    for i, line in enumerate(lines[:-2]):
        if line.startswith("== "):
            src = line[3:].strip()
        if "Function properties for" in line and any(k in line for k in (*TC_KERNELS,
                                                                          *SIMT_KERNELS)):
            name = line.split("Function properties for")[1].strip()
            out[f"{name} ({src})"] = (f"{lines[i + 2].split(':', 1)[1].strip()}; "
                                      f"{lines[i + 1].strip()}")
    return out


def ptxas_notes(build_log: str) -> dict[str, list[str]]:
    """The numbered performance notes (``(C75xx)``) that ptxas gave for
    each tensor-core kernel, by source: C7514 and C7518 say it serialised
    the ``wgmma``s, C7517 that it waited for them where the code does not
    (both defeat a ``wgmma_wait<1>`` pipeline)."""
    out, src = {}, "?"
    for line in build_log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"\((C75\d\d)\).*function '([^']+)'", line)
        if m and any(k in m.group(2) for k in TC_KERNELS):
            out.setdefault(f"{m.group(2)} ({src})", []).append(m.group(1))
    return out


def max_err(torch, got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    return float(10 * np.log10((ref**2).sum() / max(((ref - est) ** 2).sum(), 1e-30)))


def long_audio_phase(torch, seed: int, kind: str, smi: str, record, reset_counts, counts):
    """Phase 13: ``LongAudioSeparator`` on the card (module docstring).
    ``record`` keeps kernel 1's row at the hour's NMF shape; returns the
    phase's fields."""
    import threading

    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
    from gccnmf_torch.ops import gcc
    from gccnmf_torch.ops import stft as stft_ops
    from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain
    from gccnmf_torch.parallel.long_audio import LOOKAHEAD, UPLOAD_SLOTS, LongAudioSeparator
    from gccnmf_torch.utils import wav
    from gccnmf_torch.utils.hostmem import trim_host_heap

    dev = torch.device("cuda")
    want_targets = delay_targets(gcc)
    cfg32 = OfflineConfig(nmf_matmul_dtype="float32")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name

    def mixture_wav(name, seed_, seconds):
        path = os.path.join(tmp, f"{name}_mix.wav")
        wav.write_wav(make_mixture(seed_, 1, seconds)[0], path, SR)
        return path

    def outputs(result):
        return [wav.read_wav(p)[0] for p in result["paths"]]

    # ---- parity at 60 s and 10 s: no kernel launches on these paths
    p60, p10 = mixture_wav("m60", seed + 3, LONG_PARITY_S), mixture_wav("m10", seed + 4, SECONDS)
    x60 = wav.read_wav(p60)[0]
    ref32 = GCCNMFSeparator(cfg32).separate(x60)  # the kernels' float32 path
    reset_counts()
    t1 = time.perf_counter()
    st32 = LongAudioSeparator(cfg32, chunk_frames=LONG_CHUNK).separate_streamed(
        p60, os.path.join(tmp, "st32"))
    st32_s = time.perf_counter() - t1
    mem32 = LongAudioSeparator(cfg32).separate(x60)
    stdef = LongAudioSeparator(OfflineConfig(), chunk_frames=LONG_CHUNK).separate_streamed(
        p60, os.path.join(tmp, "stdef"))
    card10 = LongAudioSeparator(OfflineConfig(), chunk_frames=LONG_CHUNK).separate_streamed(
        p10, os.path.join(tmp, "card10"))
    parity_launches = counts()
    cpu10 = LongAudioSeparator(OfflineConfig(), device="cpu",
                               chunk_frames=LONG_CHUNK).separate_streamed(
        p10, os.path.join(tmp, "cpu10"))
    streamed_err = max(float(np.abs(g - e).max()) for g, e in zip(outputs(st32),
                                                                  ref32["estimates"]))
    mem_snr = [snr_db(e, g) for g, e in zip(mem32["estimates"], ref32["estimates"])]
    def_snr = [snr_db(e, g) for g, e in zip(outputs(stdef), ref32["estimates"])]
    cpu_snr = [snr_db(c, g) for g, c in zip(outputs(card10), outputs(cpu10))]
    parity = dict(
        targets=dict(streamed_f32=st32["target_tdoa_indexes"],
                     separate=mem32["target_tdoa_indexes"],
                     streamed_default=stdef["target_tdoa_indexes"],
                     gccnmf_separator=ref32["target_tdoa_indexes"], expected=want_targets,
                     card_10s=card10["target_tdoa_indexes"],
                     cpu_10s=cpu10["target_tdoa_indexes"]),
        streamed_f32_vs_separator=dict(max_abs_err=streamed_err, bar="3/32768",
                                       seconds=st32_s),
        separate_vs_separator=dict(snr_db=mem_snr, bar="> 40 dB"),
        default_vs_f32=dict(snr_db=def_snr, bar="> 20 dB"),
        card_vs_cpu_10s=dict(snr_db=cpu_snr, bar=">= 40 dB"),
        launches=parity_launches)
    # one NMF launch a call (kernel 1 float32, the one-device exact NMF) in
    # each of the four runs on the card, and no other kernel
    require(parity_launches == {**{k: 0 for k in parity_launches}, "kl_nmf_cuda": 4},
            f"long_audio: launches on the long-audio paths {parity_launches}, want 4 of "
            "kl_nmf_cuda only")
    require(ref32["target_tdoa_indexes"] == want_targets and all(
        r["target_tdoa_indexes"] == want_targets for r in (st32, mem32, stdef)),
            f"long_audio 60 s: targets {parity['targets']}")
    require(card10["target_tdoa_indexes"] == cpu10["target_tdoa_indexes"],
            f"long_audio 10 s: card targets {card10['target_tdoa_indexes']} != CPU "
            f"{cpu10['target_tdoa_indexes']}")
    require(streamed_err <= 3 / 32768, f"long_audio: streamed against the separator "
                                       f"{streamed_err} > 3/32768")
    require(min(mem_snr) > 40.0, f"long_audio: separate against the separator {mem_snr} dB")
    require(min(def_snr) > 20.0, f"long_audio: default mode against float32 {def_snr} dB")
    require(min(cpu_snr) >= 40.0, f"long_audio: card against CPU {cpu_snr} dB")
    del ref32, mem32, x60

    # ---- one hour, streamed from disk, at the default config
    path_h = mixture_wav("hour", seed + 5, HOUR_S)
    t_h = stft_ops.num_frames(HOUR_S * SR, WIN, HOP)
    sep = LongAudioSeparator(OfflineConfig())  # chunk_frames 8192, as the command
    # one chunk's host buffers: the pinned input and output rings, and the
    # float64 and float32 copies of one atom block of the seeded H0 draw
    n_in = 2 * ((sep.chunk_frames - 1) * HOP + WIN) * 2
    n_out = SOURCES * 2 * sep.chunk_frames * HOP * 2
    chunk_bytes = UPLOAD_SLOTS * n_in + (LOOKAHEAD + 1) * n_out + 8 * 2 * t_h * (8 + 4)
    mem_bound = 2 * chunk_bytes / 2**20
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trim_host_heap()
    mem_before = host_memory_mib()
    # anonymous memory: RssAnon, or VmData where the kernel has no RssAnon
    anon_key = "RssAnon" if "RssAnon" in mem_before else "VmData"
    peak = dict(mem_before)
    done = threading.Event()

    def sample():
        while not done.wait(0.02):
            for key, mib in host_memory_mib().items():
                peak[key] = max(peak[key], mib)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    reset_counts()
    t1 = time.perf_counter()
    try:
        hour = sep.separate_streamed(path_h, os.path.join(tmp, "hour"))
    finally:
        done.set()
        sampler.join()
    wall = time.perf_counter() - t1
    hour_launches = counts()
    mem_after = host_memory_mib()
    peak_dev = torch.cuda.max_memory_allocated()
    # VmData also counts the input WAV's private copy-on-write memory map
    # (scipy's mmap mode "c"), whose pages stay file-backed: nothing writes
    # them. RssAnon does not count them.
    mapped = HOUR_S * SR * 2 * 2 / 2**20 if anon_key == "VmData" else 0.0
    growth = peak[anon_key] - mem_before[anon_key] - mapped
    want_len = (t_h - 1) * HOP
    scans = []
    for p in hour["paths"]:
        reader = wav.WavReader(p)
        nonzero = sum(int(np.count_nonzero(reader.read_raw(i, 2**22)))
                      for i in range(0, reader.num_samples, 2**22))
        scans.append(dict(samples=reader.num_samples, nonzero=nonzero))
    fields = dict(
        seconds_of_audio=HOUR_S, frames=t_h, nmf_rows=2 * t_h, wall_s=wall,
        audio_s_per_s=HOUR_S / wall, stage_seconds=hour["stage_seconds"],
        transfer_mb=hour["transfer_mb"], targets=hour["target_tdoa_indexes"],
        samples_written=hour["samples_written"], outputs=scans, launches=hour_launches,
        max_memory_allocated_gib=peak_dev / 2**30,
        host_memory_mib=dict(
            before=mem_before, after=mem_after, peak=peak, bounded=anon_key,
            input_map_mib=mapped, growth_peak=growth, bound=mem_bound,
            bound_basis=(f"2 x one chunk's host buffers: {UPLOAD_SLOTS} pinned input "
                         f"chunks, {LOOKAHEAD + 1} pinned output chunks and one atom block "
                         "of the H0 draw (float64 and float32); the int16 outputs alone "
                         f"are {SOURCES * 2 * want_len * 2 / 2**20:.0f} MiB"),
            note="sampled every 20 ms from /proc/self/status; growth_peak is the bounded "
                 "key's peak less its value before, less input_map_mib for VmData (the "
                 "input WAV's copy-on-write map, file-backed); VmRSS counts the map's "
                 "pages the run touched"),
        host_heap_trims=hour["host_heap_trims"])
    emit("long_audio", device=kind, nvidia_smi=smi,
         config=f"OfflineConfig() (bfloat16_q planes, guarded fp32 NMF), chunk_frames "
                f"{sep.chunk_frames}; parity at {LONG_PARITY_S} s with chunk_frames "
                f"{LONG_CHUNK}", parity=parity, hour=fields)
    require(hour_launches == {**{k: 0 for k in hour_launches}, "kl_nmf_cuda": 1},
            f"long_audio hour: launches {hour_launches}, want one of kl_nmf_cuda only")
    require(hour["target_tdoa_indexes"] == want_targets,
            f"long_audio hour: targets {hour['target_tdoa_indexes']} != {want_targets}")
    require(hour["samples_written"] == want_len
            and all(sc["samples"] == want_len and sc["nonzero"] > 0 for sc in scans),
            f"long_audio hour: outputs {scans}, want {want_len} samples")
    require(np.isfinite(hour["w"]).all() and np.isfinite(hour["mean_angular_spectrum"]).all(),
            "long_audio hour: W or the angular spectrum is not finite")
    require(growth <= mem_bound,
            f"long_audio hour: host {anon_key} grew {growth} MiB > {mem_bound} MiB")
    del hour

    # ---- kernel 1 (float32) at the hour's NMF shape, which the path runs,
    # against the guarded plain kl_nmf that it replaced there
    pcm = wav.WavReader(path_h).read_raw(0, HOUR_S * SR)
    x = torch.as_tensor(pcm, device=dev).to(torch.float32) / 32768.0
    del pcm
    f = WIN // 2 + 1
    spec = stft_ops.stft(x, sep._window, HOP, conjugate=True)
    v = spec.abs().reshape(1, 2 * t_h, f)
    del spec, x
    w0_np, h0 = sep._h0_device_chunked(2 * t_h)
    w0, h0 = torch.as_tensor(w0_np, device=dev)[None], h0[None]
    got = kl_nmf_cuda(v, w0, h0, NMF_CHECK_ITERS, matmul_dtype="float32")
    want = kl_nmf_plain(v, w0, h0, NMF_CHECK_ITERS, matmul_dtype="float32")
    err = max(max_err(torch, g, w_)[0] for g, w_ in zip(got, want))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-6 * float(w_.abs().max()))
    del want
    # the yardstick: one iteration's four products as torch.matmul at this
    # shape (TF32 off), times the iterations
    hb, wb, q = (torch.rand(shape, device=dev)
                 for shape in ((2 * t_h, K), (WIN // 2 + 1, K), (2 * t_h, WIN // 2 + 1)))
    gemm_library_ms = time_ms(torch, lambda: (hb @ wb.T, q @ wb, q.T @ hb, hb @ wb.T),
                              3) * NMF_ITERS
    del hb, wb, q
    row = record(
        "kl_nmf_cuda", "float32", 1, "gccnmf_torch/csrc/nmf.cu",
        "gccnmf_tpu/ops/nmf_pallas.py:218", got, None, 0.0,
        lambda: kl_nmf_cuda(v, w0, h0, NMF_ITERS, matmul_dtype="float32"),
        lambda: kl_nmf_plain(v, w0, h0, NMF_ITERS, matmul_dtype="float32"),
        flops=8 * 2 * t_h * f * K * NMF_ITERS, shape=f",T{2 * t_h},K{K}",
        counted=f"4 GEMMs of 2·T·F·K per iteration, {NMF_ITERS} iterations",
        nbytes=2 * t_h * f * 4 + 2 * 4 * (f * K + 2 * t_h * K),
        check_fn=lambda: kl_nmf_cuda(v, w0, h0, NMF_CHECK_ITERS, matmul_dtype="float32"),
        err=err, reps=1,
        note=f"{NMF_CHECK_ITERS} iterations: rtol 1e-4, atol 1e-6 x max|plain|",
        iterations_timed=NMF_ITERS, design="simt2",
        timed="one call of each after a warm-up (CUDA events)",
        gemm_library_ms=gemm_library_ms,
        gemm_library_note=(f"H·Wᵀ twice, Q·W, Qᵀ·H as torch.matmul on float32 operands at "
                           f"T = {2 * t_h} (median of 3 after a warm-up), times {NMF_ITERS}; "
                           "not the same function, so library_ms stays null"),
        plain_is="the guarded plain kl_nmf (JAX's XLA path; the one-device NMF on the CPU)")
    row["launches"] = hour_launches["kl_nmf_cuda"]
    row["launches_on"] = "separate_streamed of the hour (its one-device NMF)"
    del got, v, w0, h0
    torch.cuda.empty_cache()
    tmp_dir.cleanup()
    return fields


def nmf_row_cap_phase(torch, kind: str, smi: str) -> None:
    """Phase 13's ``nmf_row_cap`` (module docstring): kernel 1 float32 past
    the row count whose H update fits one grid."""
    from gccnmf_torch.ops.nmf import nmf_init_numpy
    from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain

    dev = torch.device("cuda")
    t, f, k, iters = ROW_CAP_ROWS, 33, 8, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(t)
    v = ((torch.rand((t, 4), generator=gen, device=dev) + 0.1)
         @ (torch.rand((f, 4), generator=gen, device=dev) + 0.1).T + 0.01)[None]
    w0, h0 = (torch.as_tensor(m, device=dev)[None] for m in nmf_init_numpy(f, k, t))
    t1 = time.perf_counter()
    got = kl_nmf_cuda(v, w0, h0, iters, matmul_dtype="float32")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    want = kl_nmf_plain(v, w0, h0, iters, matmul_dtype="float32")
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-6 * float(w_.abs().max()))
    err = max(max_err(torch, g, w_)[0] for g, w_ in zip(got, want))
    ms = time_ms(torch, lambda: kl_nmf_cuda(v, w0, h0, iters, matmul_dtype="float32"), 1)
    emit("nmf_row_cap", device=kind, nvidia_smi=smi, rows=t, f=f, k=k, iterations=iters,
         h_update_row_tiles=-(-t // 64), grid_y_cap=65535, max_abs_err=err,
         bar="rtol 1e-4, atol 1e-6 x max|plain|", first_call_s=first_s, ms=ms,
         v_gb=t * f * 4 / 1e9)
    del v, w0, h0, got, want
    torch.cuda.empty_cache()


def distributed_phase(torch, seed: int, kind: str, smi: str, reset_counts, counts):
    """Phase 14: the process groups (``gccnmf_torch/parallel``) in a world of
    one over NCCL in this process, then the sharded commands as
    subprocesses (module docstring). Returns the phase's fields."""
    import torch.distributed as dist

    from gccnmf_torch import pretrain
    from gccnmf_torch.models.offline import OfflineConfig
    from gccnmf_torch.ops import gcc, nmf
    from gccnmf_torch.ops import stft as stft_ops
    from gccnmf_torch.ops.windows import hann_symmetric
    from gccnmf_torch.parallel import mesh as mesh_lib
    from gccnmf_torch.parallel.long_audio import LongAudioSeparator
    from gccnmf_torch.parallel.nmf_sharded import kl_nmf_sharded
    from gccnmf_torch.parallel.trainer import DistributedNMFTrainer
    from gccnmf_torch.utils import wav

    dev = torch.device("cuda")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    fields = {}

    def close(got, want, what):
        """max |got - want| and max |want| of each pair; fails where the
        first exceeds DIST_TOL x the second."""
        errs = [max_err(torch, torch.as_tensor(g).cpu(), torch.as_tensor(w_).cpu())
                for g, w_ in zip(got, want, strict=True)]
        require(all(e <= DIST_TOL * m for e, m in errs),
                f"distributed {what}: max |diff|, max of {errs} above {DIST_TOL} x max")
        return dict(max_abs_err=[e for e, _ in errs], max_abs=[m for _, m in errs],
                    bar=f"{DIST_TOL} x max")

    def timed(fn):
        """``(fn(), seconds)`` between two synchronisations."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def in_world(fields):
        """(e), (a), (b), (c) in a world of one over NCCL."""
        # ---- (e) NCCL: a world of one, an all_reduce and an all_gather
        _, init_s = timed(lambda: mesh_lib.init_distributed(
            f"file://{os.path.join(tmp, 'store')}", 1, 0, device=dev))
        require(dist.get_backend() == "nccl", f"distributed: backend {dist.get_backend()}")
        x = torch.arange(4096, dtype=torch.float32, device=dev)
        y = x.clone()
        _, first_s = timed(lambda: dist.all_reduce(y))
        parts = [torch.empty_like(x)]
        _, gather_s = timed(lambda: dist.all_gather(parts, x))
        require(torch.equal(y, x) and torch.equal(parts[0], x), "distributed: NCCL collectives")
        mesh, mesh_s = timed(lambda: mesh_lib.make_mesh(device=dev))
        fields["nccl"] = dict(init_process_group_s=init_s, first_all_reduce_s=first_s,
                              all_gather_s=gather_s, init_device_mesh_s=mesh_s,
                              world=dist.get_world_size(), backend=dist.get_backend(),
                              mesh=list(mesh.shape))
        emit("distributed", check="nccl", device=kind, nvidia_smi=smi, **fields["nccl"])

        # ---- (a) the sharded NMF at a 60 s mixture's V against the one-device NMF
        mix = torch.as_tensor(make_mixture(seed + 6, 1, DIST_NMF_S)[0], device=dev)
        spec = stft_ops.stft(mix, torch.as_tensor(hann_symmetric(WIN), device=dev), HOP)
        v = torch.cat([spec[0].abs(), spec[1].abs()])
        del spec, mix
        w0, h0 = (torch.as_tensor(a, device=dev) for a in nmf.nmf_init_numpy(v.shape[1], K,
                                                                              v.shape[0]))
        nmf_rows = {}
        for name, kw, one in (("unguarded", {}, lambda: nmf.kl_nmf(v, w0, h0, NMF_ITERS)),
                              ("guard", dict(guard=True),
                               lambda: nmf.kl_nmf(v, w0, h0, NMF_ITERS, guard=True)),
                              ("simultaneous", dict(simultaneous=True),
                               lambda: nmf.kl_nmf_simul(v, w0, h0, NMF_ITERS))):
            sharded = functools.partial(kl_nmf_sharded, v, w0, h0, NMF_ITERS, mesh, **kw)
            nmf_rows[name] = dict(**close(sharded(), one(), f"kl_nmf_sharded {name}"),
                                  sharded_ms=time_ms(torch, sharded, 3),
                                  one_device_ms=time_ms(torch, one, 3))
        fields["kl_nmf_sharded"] = dict(shape=f"V ({v.shape[0]}, {v.shape[1]}), K = {K}, "
                                              f"{NMF_ITERS} iterations", mesh="(1, 1)",
                                        timed="median of 3 after a warm-up (CUDA events)",
                                        modes=nmf_rows)
        emit("distributed", check="kl_nmf_sharded", device=kind, nvidia_smi=smi,
             **fields["kl_nmf_sharded"])
        del v, w0, h0

        # ---- (b) the trainer at the pretraining corpus's shape, and its resume
        corpus = (np.random.default_rng(seed + 7).random((PRETRAIN_FRAMES, WIN // 2 + 1))
                  + 0.05).astype(np.float32)
        kw = dict(dictionary_size=DIST_TRAIN_K, num_iterations=NMF_ITERS,
                  checkpoint_every=NMF_ITERS // 2)
        ck_a, ck_b = os.path.join(tmp, "ck_a"), os.path.join(tmp, "ck_b")
        w_tr, train_s = timed(lambda: DistributedNMFTrainer(mesh, checkpoint_dir=ck_a, **kw)
                              .fit(corpus))
        init = nmf.nmf_init_numpy(corpus.shape[1], DIST_TRAIN_K, corpus.shape[0])
        args_c = [torch.as_tensor(a, device=dev) for a in (corpus, *init)]
        (w_one, _), one_s = timed(lambda: pretrain.corpus_nmf(*args_c, NMF_ITERS))
        half_ck = f"nmf_{NMF_ITERS // 2:06d}.npz"
        os.makedirs(ck_b)
        shutil.copy(os.path.join(ck_a, half_ck), ck_b)
        with open(os.path.join(ck_b, "latest"), "w") as fh:
            fh.write(half_ck)
        w_res, resume_s = timed(lambda: DistributedNMFTrainer(mesh, checkpoint_dir=ck_b, **kw)
                                .fit(corpus))
        fields["trainer"] = dict(
            corpus=list(corpus.shape), k=DIST_TRAIN_K, iterations=NMF_ITERS,
            checkpoint_every=NMF_ITERS // 2, seconds=train_s, corpus_nmf_seconds=one_s,
            resumed_seconds=resume_s, vs_corpus_nmf=close([w_tr], [w_one], "trainer"),
            resumed_vs_uninterrupted=close([w_res], [w_tr], "resumed trainer"),
            resumed_bit_equal=bool(np.array_equal(w_res, w_tr)),
            checkpoints=sorted(os.listdir(ck_a)))
        emit("distributed", check="trainer", device=kind, nvidia_smi=smi, **fields["trainer"])
        del args_c, w_one

        # ---- (c) the sharded separator against the mesh-less one, 10 minutes.
        # The mesh runs JAX's plain guarded updates (kl_nmf_sharded); the
        # mesh-less reference here runs the same updates (nmf.kl_nmf with
        # the guards, as JAX's one-device path does), so that the two differ
        # only by the sharding. The mesh-less separator as users run it
        # (kernel 1 float32 for its NMF) is held against it after the turns.
        x = make_mixture(seed + 8, 1, DIST_SEP_S)[0]
        seps = {"mesh": LongAudioSeparator(OfflineConfig(), mesh=mesh),
                "mesh_less": LongAudioSeparator(OfflineConfig())}
        plain_sep = seps["mesh_less"]

        def plain_nmf(v2, w0, h0):
            cfg_ = plain_sep.config
            return nmf.kl_nmf(v2, torch.as_tensor(w0, device=dev), h0, cfg_.num_iterations,
                              cfg_.sparsity_alpha, cfg_.epsilon, guard=True)

        plain_sep._run_nmf = plain_nmf
        runs = {name: dict(seconds=[], max_memory_allocated_gib=[]) for name in seps}
        outs = {}
        # in turns, so neither side alone pays the first call's warm-up
        for name in ("mesh", "mesh_less", "mesh_less", "mesh"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            outs[name], sec = timed(lambda name=name: seps[name].separate(x))
            runs[name]["seconds"].append(sec)
            runs[name]["max_memory_allocated_gib"].append(
                torch.cuda.max_memory_allocated() / 2**30)
        for run in runs.values():
            run["audio_s_per_s"] = [DIST_SEP_S / sec for sec in run["seconds"]]
        a, b = outs["mesh"], outs["mesh_less"]
        snrs = [snr_db(r, e) for r, e in zip(b["estimates"], a["estimates"])]
        require(a["target_tdoa_indexes"] == b["target_tdoa_indexes"] == delay_targets(gcc),
                f"distributed separator: targets {a['target_tdoa_indexes']} vs "
                f"{b['target_tdoa_indexes']}")
        require(a["estimates"].shape == b["estimates"].shape and min(snrs) > 40.0,
                f"distributed separator: {snrs} dB against the mesh-less run")
        fields["separator"] = dict(
            seconds_of_audio=DIST_SEP_S, frames=a["frames_processed"], config="OfflineConfig()",
            targets=a["target_tdoa_indexes"], w=close([a["w"]], [b["w"]], "separator W"),
            snr_db=snrs, snr_bar="> 40 dB", order="mesh, mesh_less, mesh_less, mesh", **runs)
        launches = counts()
        require(sum(launches.values()) == 0, f"distributed: a kernel launched: {launches}")
        routed = LongAudioSeparator(OfflineConfig()).separate(x)  # kernel 1 for the NMF
        routed_launches = counts()
        routed_snrs = [snr_db(r, e) for r, e in zip(b["estimates"], routed["estimates"])]
        require(routed["target_tdoa_indexes"] == b["target_tdoa_indexes"]
                and min(routed_snrs) > 40.0
                and routed_launches == {**launches, "kl_nmf_cuda": 1},
                f"distributed: the routed mesh-less separator {routed['target_tdoa_indexes']}, "
                f"{routed_snrs} dB, launches {routed_launches}")
        fields["separator"]["routed_mesh_less"] = dict(
            snr_db=routed_snrs, snr_bar="> 40 dB", launches=routed_launches,
            note="LongAudioSeparator(OfflineConfig()).separate as users run it (kernel 1 "
                 "float32 for the NMF) against the plain-updates reference")
        emit("distributed", check="separator", device=kind, nvidia_smi=smi, **fields["separator"])
        del routed

    reset_counts()
    try:
        in_world(fields)
    finally:  # a live NCCL group would keep the process from exiting
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (d) the commands, each in a process of its own
    def command(*argv):
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "gccnmf_torch.cli", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        return res, time.perf_counter() - t1

    wav_paths = []
    for i in range(4):
        wav_paths.append(os.path.join(tmp, f"cmd{i}_mix.wav"))
        wav.write_wav(make_mixture(seed + 9 + i, 1, SECONDS)[0], wav_paths[-1], SR)
    res, sec = command(wav_paths[0], "--time-shards", "1", "--streamed", "-o",
                       os.path.join(tmp, "ts1"))
    require(res.returncode == 0, f"separate --time-shards 1 --streamed: {res.stderr[-2000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    require(line["target_tdoa_indexes"] == delay_targets(gcc) and all(
        np.isfinite(wav.read_wav(p)[0]).all() for p in line["outputs"]),
        f"separate --time-shards 1 --streamed: {line}")
    cmds = {"separate --time-shards 1 --streamed": dict(rc=0, seconds=sec, json=line)}
    res, sec = command(wav_paths[0], "--time-shards", "2", "-o", os.path.join(tmp, "ts2"))
    n_cards = torch.cuda.device_count()
    if n_cards < 2:  # this one-card machine: no rank may move to the CPU
        require(res.returncode != 0 and "exceeds" in res.stderr
                and not os.path.exists(os.path.join(tmp, "ts2_sim_1.wav")),
                f"separate --time-shards 2 on {n_cards} card: rc {res.returncode}, "
                f"{res.stderr[-2000:]}")
    cmds["separate --time-shards 2"] = dict(
        rc=res.returncode, seconds=sec, cards=n_cards,
        stderr_last=(res.stderr.strip().splitlines() or [""])[-1])
    saved = {}
    for name, extra in (("pretrain --data-shards 1", ["--data-shards", "1"]),
                        ("pretrain", [])):
        save = os.path.join(tmp, f"save_{len(saved)}")
        res, sec = command("pretrain", *wav_paths, "--sizes", "64", "--cache-dir",
                           os.path.join(tmp, f"cache_{len(saved)}"), "--save-dir", save, *extra)
        require(res.returncode == 0, f"{name}: {res.stderr[-2000:]}")
        saved[name] = np.load(os.path.join(save, "W_64.npy"))
        cmds[name] = dict(rc=0, seconds=sec, json=json.loads(res.stdout.strip().splitlines()[-1]))
    cmds["pretrain --data-shards 1"]["w_vs_pretrain"] = close(
        [saved["pretrain --data-shards 1"]], [saved["pretrain"]], "pretrain --data-shards 1")
    fields["commands"] = cmds
    emit("distributed", check="commands", device=kind, nvidia_smi=smi, commands=cmds)
    tmp_dir.cleanup()
    return fields


def realtime_phase(torch, kind: str, smi: str, reset_counts, counts, w_rt, audio):
    """Phase 15: the realtime app (``gccnmf_torch/realtime``) and the native
    host runtime at the stream phase's configuration, one JSON line per
    check (module docstring). ``w_rt`` is the stream phase's dictionary,
    ``audio`` its seeded 10 s int16-born mixture (2, n)."""
    import threading

    from gccnmf_torch import cli, native
    from gccnmf_torch.config import GCCNMFConfig
    from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig, StreamParams
    from gccnmf_torch.native import build as native_build
    from gccnmf_torch.native import runtime as native_rt
    from gccnmf_torch.realtime import FilePlayerSource, RealtimeGCCNMF
    from gccnmf_torch.utils import wav

    dev = torch.device("cuda")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    src, dic = os.path.join(tmp, "realtime_mix.wav"), os.path.join(tmp, "W_64.npy")
    wav.write_wav(audio, src, SR)
    np.save(dic, w_rt)
    cfg = GCCNMFConfig(dictionary_file=dic)
    scfg = StreamConfig.from_app_config(cfg)
    n_blocks = audio.shape[-1] // scfg.block_size
    deadline_ms = scfg.block_size / scfg.sample_rate * 1e3
    line = dict(device=kind, nvidia_smi=smi,
                config="GCCNMFConfig() (window 1024, hop 512, block 512, 64 TDOAs at 0.1 m, "
                       "K = 64), the stream phase's W and its 10 s mixture as a WAV")
    reset_counts()

    # ---- native: the host runtime's library, each function against its
    # NumPy path on the same seeded arrays
    t1 = time.perf_counter()
    lib_path = native_build.build(force=True)
    build_s = time.perf_counter() - t1
    require(lib_path is not None and native.available(), "native: the library did not build")
    rng = np.random.default_rng(0)
    pcm = rng.integers(-32768, 32768, size=2 * 4099, dtype=np.int16)
    planar = rng.uniform(-1.2, 1.2, (2, 4096)).astype(np.float32)
    chunks = [rng.standard_normal(int(n)).astype(np.float32) for n in rng.integers(1, 3000, 40)]
    frames = rng.standard_normal((12, 2, 4, 1024)).astype(np.float32)
    times_ = rng.uniform(0.001, 0.05, 300)

    def run_all():
        ring, got = native.SpscRing(2048), []
        for c in chunks:  # wraps the ring many times
            got.append(np.array([ring.write(c)], np.float32))
            got.append(ring.read(int(c.size * 0.9)))
        ola, emitted = native.OverlapAdd(2, 512, 8), []
        for f in frames:
            ola.add_block(f, 128)
            emitted.append(ola.emit_block())
        bt = native.BlockTimes(256)
        for v in times_:
            bt.record(v)
        return dict(
            lib=ring._lib is not None and ola._lib is not None and bt._lib is not None,
            results=[native.pcm16_to_float(pcm), native.float_to_pcm16(planar),
                     native.deinterleave_pcm16(pcm[:-1], 2), native.interleave_pcm16(planar),
                     np.concatenate(got), np.stack(emitted), np.sort(bt.snapshot())],
            stats=bt.stats())

    compiled = run_all()
    load = native_rt._load
    native_rt._load = lambda: None
    try:
        numpy_path = run_all()
    finally:
        native_rt._load = load
    require(compiled["lib"] and not numpy_path["lib"], "native: the two paths did not run")
    names = ["pcm16_to_float", "float_to_pcm16", "deinterleave_pcm16", "interleave_pcm16",
             "SpscRing", "OverlapAdd", "BlockTimes.snapshot"]
    for name, a, b in zip(names, compiled["results"], numpy_path["results"], strict=True):
        require(a.dtype == b.dtype and np.array_equal(a, b), f"native: {name} differs")
    (mn, mx, mean, held), want = compiled["stats"], numpy_path["stats"]
    require((mn, mx, held) == (want[0], want[1], want[3])
            and abs(mean - want[2]) <= 1e-12 * want[2], "native: BlockTimes.stats differ")
    emit("realtime", check="native", **line, library=os.path.relpath(lib_path, ROOT),
         build_s=build_s, bit_equal=names, stats_mean_bar="1e-12 relative (NumPy's pairwise sum)")

    # ---- app: RealtimeGCCNMF on the card against enhance_signal, depth 2
    # against depth 0, the CPU app, and the histories against the eager step
    class Collect:
        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(block)

        def audio(self):
            return np.concatenate(self.blocks, axis=-1)

    runs = {}
    for name, depth, device in (("card, depth 0", 0, None), ("card, depth 2", 2, None),
                                ("cpu", 0, "cpu")):
        app = RealtimeGCCNMF(src, config=cfg, pipeline_depth=depth, device=device)
        out, got = os.path.join(tmp, f"rt_{depth}_{device}.wav"), Collect()
        stats = app.run(output_path=out, output_stream=got)
        require(stats["blocks"] == n_blocks and len(got.blocks) == n_blocks,
                f"realtime app {name}: {stats['blocks']} blocks")
        runs[name] = dict(app=app, stats=stats, out=got.audio(), file=out)
    card, piped, cpu_run = runs["card, depth 0"], runs["card, depth 2"], runs["cpu"]
    with open(card["file"], "rb") as fh0, open(piped["file"], "rb") as fh2:
        require(fh0.read() == fh2.read(), "realtime app: the depth-2 file differs from depth 0")
    app = card["app"]
    params = StreamParams(*(p.to(dev) for p in app.params))
    require(all(p.device.type == "cpu" for p in app.params), "realtime app: params on the card")
    signal, _ = wav.read_wav(src)
    proc = RTGCCNMFProcessor(w_rt, scfg)
    ref = proc.enhance_signal(signal, params)[0]
    err, scale = float(np.abs(card["out"] - ref).max()), float(np.abs(ref).max())
    require(err <= 1e-6 * scale, f"realtime app against enhance_signal: {err} > 1e-6 x {scale}")
    cpu = cpu_run["out"]
    snr = snr_db(cpu, card["out"])
    tight = float((np.abs(card["out"] - cpu) < 3e-4 * np.abs(cpu).max()).mean())
    require(snr > 25.0 and tight > 0.93, f"realtime app: card against CPU {snr} dB, {tight}")
    # the histories hold the last 128 blocks: each equals the eager step's
    # telemetry of that block on the card
    hist = app.histories
    state, tels = proc.init_state(1), []
    for block in FilePlayerSource(src, scfg.block_size).blocks():
        state, _, tel = proc.eager_step(state, torch.as_tensor(block[None], device=dev), params)
        tels.append({k: v.cpu().numpy() for k, v in tel.items()})
    held = hist["gcc_phat"].num_values
    tel_err = {}
    for key, tkey in (("gcc_phat", "gcc_phat"), ("input_spectrogram", "input_mag"),
                      ("output_spectrogram", "output_mag"),
                      ("coefficient_mask", "coefficient_mask")):
        want_h = np.concatenate([t[tkey][0] for t in tels])[-held:]
        got_h = hist[key].get()
        e, s = float(np.abs(got_h - want_h).max()), float(np.abs(want_h).max())
        require(got_h.shape == want_h.shape and e <= 1e-6 * s,
                f"realtime app: history {key} against the eager telemetry {e} > 1e-6 x {s}")
        tel_err[key] = dict(max_abs_err=e, bar=f"1e-6 x {s}")
    want_t = np.concatenate([t["target_tdoa_index"] for t in tels])[-held:]
    require(np.array_equal(hist["tdoa"].get(), want_t),
            "realtime app: the target history differs from the eager step's")
    # the app's host cost: the warm app over the whole file again, unpaced,
    # against enhance_signal at B = 1 (median of 3 after a warm-up each)
    app_s, es_s = [], []
    proc.enhance_signal(signal, params)
    for _ in range(STREAM_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        app.run()
        app_s.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        proc.enhance_signal(signal, params)
        es_s.append(time.perf_counter() - t1)
    app_s, es_s = statistics.median(app_s), statistics.median(es_s)
    keys = ("p50_ms", "p99_ms", "deadline_misses")
    emit("realtime", check="app", **line, blocks=n_blocks,
         app_vs_enhance_signal=dict(max_abs_err=err, bar=f"1e-6 x {scale}"),
         card_vs_cpu=dict(snr_db=snr, tight_share=tight, bars="> 25 dB, > 0.93"),
         depth2_file_vs_depth0="byte-identical",
         histories_vs_eager=dict(blocks=held, target_tdoa_index="equal", **tel_err),
         per_block_depth0={k: card["stats"][k] for k in keys},
         per_block_depth2={k: piped["stats"][k] for k in keys},
         per_block_cpu={k: cpu_run["stats"][k] for k in keys},
         first_build_and_capture_ms=app.rebuild_ms[0],
         unpaced=dict(app_s=app_s, app_audio_s_per_s=SECONDS / app_s,
                      enhance_signal_b1_s=es_s, enhance_signal_audio_s_per_s=SECONDS / es_s,
                      app_host_ms_per_block=(app_s - es_s) / n_blocks * 1e3))
    del runs, card, piped, cpu_run, app

    # ---- command: cli.main(["realtime", ...]) paced at the deadline, then
    # unpaced over the whole file
    cmd = {}
    for name, extra in (("paced, 94 blocks", ["--realtime-pace", "--blocks", "94"]),
                        ("unpaced, whole file", [])):
        out = os.path.join(tmp, f"cmd_{len(cmd)}.wav")
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["realtime", "-i", src, "-o", out, "--dictionary-file", dic, *extra])
        seconds = time.perf_counter() - t1
        info = json.loads(buf.getvalue().strip().splitlines()[-1])
        data, _ = wav.read_wav(info["output"])
        want_blocks = 94 if extra else n_blocks
        require(rc == 0 and info["blocks"] == want_blocks and np.isfinite(data).all()
                and data.shape == (2, want_blocks * scfg.block_size),
                f"realtime command {name}: {info}")
        cmd[name] = dict(seconds=seconds, **{k: info[k] for k in (*keys, "deadline_ms")})
    paced = cmd["paced, 94 blocks"]
    require(paced["p99_ms"] < deadline_ms,
            f"realtime --realtime-pace: p99 {paced['p99_ms']} ms >= {deadline_ms} ms")
    emit("realtime", check="command", **line,
         argv="realtime -i <wav> -o <out> --dictionary-file W_64.npy [--realtime-pace "
              "--blocks 94]", runs=cmd)

    # ---- storm: 300 blocks on the audio thread while a second thread sets
    # and reads without pause and fires every structural setter at its
    # block; the audio thread waits for the setter due before a block and
    # for at least one read after each block, and captures each new engine
    # while the reads go on
    w128 = np.concatenate([w_rt, np.random.default_rng(1).random(w_rt.shape, np.float32)
                           * float(w_rt.mean())], axis=1)
    app = RealtimeGCCNMF(src, config=GCCNMFConfig(dictionary_sizes=(64, 128)),
                         dictionaries={"Pretrained": {64: w_rt, 128: w128}})
    schedule = {30: ("set_dictionary", dict(size=128)), 60: ("set_dictionary", dict(size=64)),
                90: ("set_num_tdoas", dict(num_tdoas=48)),
                120: ("set_mic_separation", dict(metres=0.2)),
                150: ("set_num_h_updates", dict(n=2)), 180: ("set_target_mode", dict(mode="boxcar")),
                210: ("set_block_geometry", dict(hop_size=256))}
    fired = {at: threading.Event() for at in schedule}
    errors, done, reads = [], [0], [0]
    stop = threading.Event()

    def host_values():
        h = app.histories
        w = app.peek_dictionary()
        return (isinstance(app.config, GCCNMFConfig)
                and all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
                        for p in app.params)
                and all(isinstance(b.get_unraveled(), np.ndarray) for b in h.values())
                and (w is None or isinstance(w, np.ndarray))
                and isinstance(app.dictionary_size, int) and isinstance(app.dictionary_type, str))

    def control():
        try:
            while not stop.is_set():
                app.set_target_window(target_tdoa_index=float(done[0] % 48), epsilon=4.0)
                if not host_values():
                    raise RuntimeError(f"a GUI read returned a device value at block {done[0]}")
                reads[0] += 1
                for at in [at for at in schedule if at <= done[0] and not fired[at].is_set()]:
                    name, kw = schedule[at]
                    getattr(app, name)(**kw)
                    fired[at].set()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    def wait(cond, what):
        t_end = time.perf_counter() + 30.0
        while not cond():
            require(not errors and time.perf_counter() < t_end,
                    f"realtime storm: waiting for {what}: {errors}")
            time.sleep(0.0001)

    memory = []
    thread = threading.Thread(target=control)
    thread.start()
    finite = True
    try:
        blocks = FilePlayerSource(src, scfg.block_size, loop=True).blocks()
        for i in range(300):
            if i in fired:
                wait(fired[i].is_set, f"the setter due at block {i}")
            builds, seen = len(app.rebuild_ms), reads[0]
            out = app.process_block(next(blocks))
            finite &= out is not None and bool(np.isfinite(out).all())
            if len(app.rebuild_ms) != builds:
                memory.append(dict(build=len(app.rebuild_ms), block=i,
                                   allocated_mib=torch.cuda.memory_allocated(dev) / 2**20,
                                   reserved_mib=torch.cuda.memory_reserved(dev) / 2**20))
            done[0] = i + 1
            wait(lambda: reads[0] > seen, f"a read after block {i}")
    finally:
        stop.set()
        thread.join(timeout=60)
    require(not errors and not thread.is_alive(), f"realtime storm: {errors}")
    require(finite, "realtime storm: an output was missing or not finite")
    require(len(app.rebuild_ms) == 8, f"realtime storm: {len(app.rebuild_ms)} builds, not 8")
    require(host_values(), "realtime storm: a GUI read returned a device value")
    storm_ms = list(app.rebuild_ms)
    # twenty rebuilds of one configuration: device memory after the first
    # and after the last
    same = []
    for _ in range(20):
        app.set_target_mode("boxcar")
        require(bool(np.isfinite(app.process_block(next(blocks))).all()),
                "realtime rebuilds: output not finite")
        same.append(torch.cuda.memory_allocated(dev) / 2**20)
    require(same[-1] <= same[0] + 1.0,
            f"realtime rebuilds: memory_allocated grew {same[0]} -> {same[-1]} MiB")
    c = counts()
    require(all(v == 0 for v in c.values()), f"the realtime phase launched a kernel: {c}")
    emit("realtime", check="storm", **line, blocks=300, reads=reads[0],
         rebuilds=[f"{name}({kw})" for name, kw in schedule.values()],
         build_and_capture_ms=storm_ms, memory=memory,
         twenty_rebuilds=dict(change="set_target_mode('boxcar')",
                              allocated_mib_after_first=same[0], allocated_mib_after_last=same[-1],
                              build_and_capture_ms=list(app.rebuild_ms)[-20:],
                              reserved_mib=torch.cuda.memory_reserved(dev) / 2**20),
         gui_reads="config, params.*, histories, peek_dictionary(), dictionary_size/type "
                   "are host values", launches=c)
    del app
    tmp_dir.cleanup()


def serve_mesh_phase(torch, kind: str, smi: str, reset_counts, counts, w_rt, scfg, blocks_rt):
    """Phase 16: ``StreamServer(mesh=LocalMesh)`` at the serve phase's
    configuration against the unsharded server (module docstring)."""
    from gccnmf_torch.parallel.mesh import local_mesh
    from gccnmf_torch.serving import StreamServer, StreamSettings

    meshes = {"unsharded": None, "mesh1": local_mesh(1),
              "mesh2": local_mesh(2, devices=["cuda:0", "cuda:0"])}

    def run(name, wire):
        """SERVE_TICKS ticks of every slot's stream on server ``name``:
        per stream its blocks and its last telemetry target, and the run's
        tick stats."""
        server = StreamServer(w_rt, scfg, max_streams=SERVE_SLOTS, pipeline_depth=2,
                              async_fetch=True, wire_dtype=wire, mesh=meshes[name])
        sids = [server.open_stream(StreamSettings(target_tdoa_index=scfg.num_tdoas / 2.0))
                for _ in range(SERVE_SLOTS)]
        got = {sid: [] for sid in sids}
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(SERVE_TICKS):
            out = server.process({sid: blocks_rt[t, i] for i, sid in enumerate(sids)})
            for sid, blk in out.items():
                got[sid].append(blk)
        for tail in server.flush():
            for sid, blk in tail.items():
                got[sid].append(blk)
        wall = time.perf_counter() - t1
        tel = server.telemetry
        server.close()
        c = counts()
        require(all(v == 0 for v in c.values()), f"serve_mesh {name}: a kernel launched: {c}")
        outs = np.stack([np.concatenate(got[sid], axis=-1) for sid in sids])
        require(outs.shape == (SERVE_SLOTS, 2, SERVE_TICKS * scfg.block_size)
                and np.isfinite(outs).all(), f"serve_mesh {name}: output shape or values")
        stats = server.tick_stats()
        audio_s = SERVE_SLOTS * SERVE_TICKS * scfg.block_size / scfg.sample_rate
        row = dict(server=name, wire=wire, shards=len(server._shards), wall_s=wall,
                   realtime_factor=audio_s / wall, tick_p50_ms=stats["tick_ms"]["p50"],
                   tick_p99_ms=stats["tick_ms"]["p99"], deadline_misses=stats["deadline_misses"],
                   delivery_ms=stats["delivery_ms"])
        return outs, [tel[sid]["target_tdoa_index"] for sid in sids], row

    order = ["unsharded", "mesh1", "mesh2", "mesh2", "mesh1", "unsharded"]
    rows, ref, ref_targets, err = [], None, None, 0.0
    for name in order:
        outs, targets, row = run(name, "float32")
        rows.append(row)
        if ref is None:
            ref, ref_targets = outs, targets
            continue
        require(targets == ref_targets, f"serve_mesh {name}: telemetry targets differ")
        row["max_abs_err"] = float(np.abs(outs - ref).max())
        err = max(err, row["max_abs_err"])
    require(err <= 1e-5, f"serve_mesh: a stream against the unsharded server {err} > 1e-5")
    # the int16 wire quantizes as the WAV writer does: clip, then truncate
    clipped, wire_err = np.clip(ref, -1.0, 1.0 - 2.0**-15), 0.0
    for name in ("mesh1", "mesh2"):
        outs, targets, row = run(name, "int16")
        rows.append(row)
        require(targets == ref_targets, f"serve_mesh {name} int16: telemetry targets differ")
        row["max_abs_err"] = float(np.abs(outs - clipped).max())
        wire_err = max(wire_err, row["max_abs_err"])
    require(wire_err <= 2.0**-15 + 1e-7, f"serve_mesh: int16 wire against float32 {wire_err}")
    default_two = "not checked: more than one card"
    if torch.cuda.device_count() == 1:
        try:
            local_mesh(2)
        except ValueError as e:
            require("exceeds" in str(e), f"local_mesh(2): {e}")
            default_two = f"raises ValueError: {e}"
        else:
            require(False, "local_mesh(2) did not raise on a one-card machine")
    emit("serve_mesh", device=kind, nvidia_smi=smi,
         config=f"GCCNMFConfig(), {SERVE_SLOTS} slots, {SERVE_SLOTS} streams, {SERVE_TICKS} "
                "ticks, pipeline_depth=2, async_fetch=True",
         meshes={"mesh1": "local_mesh(1)", "mesh2": "local_mesh(2, ['cuda:0', 'cuda:0'])"},
         order=order + ["mesh1 int16", "mesh2 int16"], runs=rows,
         stream_vs_unsharded=dict(max_abs_err=err, bar="1e-5"),
         int16_vs_float32=dict(max_abs_err=wire_err,
                               bar="2^-15 + 1e-7 against the clipped float32 output"),
         targets="equal", default_local_mesh_2=default_two)


def conv_stft_phase(torch, kind: str, smi: str, reset_counts, counts, mix0):
    """Phase 17: the conv STFT (cuDNN) against ``fft`` on the card, alone
    and through the plain float32 separator (module docstring)."""
    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
    from gccnmf_torch.ops import stft as stft_ops
    from gccnmf_torch.ops.windows import hann_symmetric

    y = torch.as_tensor(mix0, device="cuda")
    win = hann_symmetric(WIN)
    methods = ("fft", "conv")
    reset_counts()
    spec = {m: stft_ops.stft(y, win, HOP, conjugate=True, method=m) for m in methods}
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    scale = float(spec["fft"].abs().max())
    stft_err = float((spec["conv"] - spec["fft"]).abs().max())
    require(stft_err <= 2e-4 * scale, f"conv stft against fft {stft_err} > 2e-4 x {scale}")
    inv = {m: stft_ops.istft(spec["fft"], win, HOP, conjugate=True, center_trim=True, method=m)
           for m in methods}
    inv_scale = float(inv["fft"].abs().max())
    istft_err = float((inv["conv"] - inv["fft"]).abs().max())
    require(istft_err <= 5e-5 * inv_scale,
            f"conv istft against fft {istft_err} > 5e-5 x {inv_scale}")
    ms = {f"stft_{m}": time_ms(torch, lambda m=m: stft_ops.stft(
        y, win, HOP, conjugate=True, method=m)) for m in methods}
    ms.update({f"istft_{m}": time_ms(torch, lambda m=m: stft_ops.istft(
        spec["fft"], win, HOP, conjugate=True, center_trim=True, method=m)) for m in methods})
    # on the card the front-end and synthesis kernels take the STFT's
    # place, as the Pallas kernels do in JAX: the plain backends keep it
    seps = {m: GCCNMFSeparator(OfflineConfig(
        nmf_matmul_dtype="float32", stft_method=m, nmf_backend="torch",
        frontend_backend="torch", synthesis_backend="torch")) for m in methods}
    res, secs = {}, {m: [] for m in methods}
    for m in methods:
        seps[m].separate(mix0)  # warm-up
    for m in ("fft", "conv", "conv", "fft"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res[m] = seps[m].separate(mix0)
        secs[m].append(time.perf_counter() - t1)
    c = counts()
    require(all(v == 0 for v in c.values()), f"conv_stft: a kernel launched: {c}")
    got, want = res["conv"], res["fft"]
    require(got["target_tdoa_indexes"] == want["target_tdoa_indexes"],
            f"conv targets {got['target_tdoa_indexes']} != fft {want['target_tdoa_indexes']}")
    snrs = [snr_db(r, e) for r, e in zip(want["estimates"], got["estimates"])]
    require(min(snrs) > 25.0, f"conv separation against fft: SNR {snrs}")
    emit("conv_stft", device=kind, nvidia_smi=smi,
         signal=f"the first mixture, (2, {mix0.shape[-1]}), window {WIN}, hop {HOP}",
         stft_vs_fft=dict(max_abs_err=stft_err, bar=f"2e-4 x {scale}"),
         istft_vs_fft=dict(max_abs_err=istft_err, bar=f"5e-5 x {inv_scale}"),
         ms=ms, cudnn_tf32=False,
         separate=dict(config="OfflineConfig(nmf_matmul_dtype='float32', stft_method=m), "
                              "plain backends", targets=got["target_tdoa_indexes"],
                       snr_db_vs_fft=snrs, seconds=secs, order="fft, conv, conv, fft"),
         launches=c)


def metrics_phase(kind: str, smi: str, seed: int, separated: dict):
    """Phase 18: the port's scores of the separate phase's three outputs of
    the first mixture against its seeded sources (module docstring)."""
    from gccnmf_torch import metrics

    est = separated["estimates"]  # (3, 2, n_out)
    n_out = est.shape[-1]
    src = make_sources(seed, MAIN_BATCH)[0]
    # the ISTFT's center trim drops the first WIN // 2 samples of the input
    refs = np.stack([np.stack([s, np.roll(s, d)]) for s, d in zip(src, DELAYS)])
    refs = refs[..., WIN // 2:WIN // 2 + n_out]
    seconds, t1 = {}, time.perf_counter()
    sdr, sir, sar, perm = metrics.bss_eval_sources(refs, est)
    seconds["bss_eval_sources"] = time.perf_counter() - t1
    scores = {"bss_sdr_db": sdr.tolist(), "bss_sir_db": sir.tolist(), "bss_sar_db": sar.tolist()}
    for name, fn in (("si_sdr", lambda r, e: metrics.si_sdr(r, e)),
                     ("stoi", lambda r, e: metrics.stoi(r, e, SR)),
                     ("pesq", lambda r, e: metrics.pesq(r, e, SR))):
        t1 = time.perf_counter()
        scores[name] = [float(fn(refs[perm[j]], est[j])) for j in range(len(est))]
        seconds[name] = time.perf_counter() - t1
    require(all(np.isfinite(v).all() for v in scores.values()), f"a score is not finite: {scores}")
    # the P.862.2 mapping of a raw score in [-0.5, 4.5] lies in [0.999, 4.644]
    require(all(0.999 <= p <= 4.65 for p in scores["pesq"]), f"pesq out of range: {scores['pesq']}")
    emit("metrics", device=kind, nvidia_smi=smi,
         signals=f"separate's {len(est)} estimates (2, {n_out}) of the first mixture against "
                 f"its seeded sources' images at the two mics from sample {WIN // 2}",
         perm=[int(p) for p in perm], scores=scores, seconds=seconds)


def stamp_phase(torch, kind: str, smi: str):
    """Phase 19: ``run_stamp`` in this process and in a fresh one, neither
    call creating a CUDA context (module docstring)."""
    from gccnmf_torch.models.offline import OfflineConfig
    from gccnmf_torch.utils.stamp import config_fingerprint, run_stamp

    before = torch.cuda.is_initialized()
    here = run_stamp(config_fingerprint(OfflineConfig()))
    require(torch.cuda.is_initialized() == before, "run_stamp changed the CUDA state")
    code = ("import json, torch\n"
            "from gccnmf_torch.models.offline import OfflineConfig\n"
            "from gccnmf_torch.utils.stamp import config_fingerprint, run_stamp\n"
            "s = run_stamp(config_fingerprint(OfflineConfig()))\n"
            "print(json.dumps(dict(stamp=s, cuda_initialized=torch.cuda.is_initialized())))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    require(res.returncode == 0, f"stamp subprocess: {res.stderr[-2000:]}")
    fresh = json.loads(res.stdout.strip().splitlines()[-1])
    require(not fresh["cuda_initialized"], "run_stamp created a CUDA context")
    keys = {"git_sha", "utc", "torch_version", "torch_cuda", "config_fingerprint"}
    require(set(here) == keys == set(fresh["stamp"]), f"stamp keys {sorted(here)}")
    require(here["config_fingerprint"] == fresh["stamp"]["config_fingerprint"],
            "config_fingerprint differs between processes")
    emit("stamp", device=kind, nvidia_smi=smi, stamp=here,
         cuda_initialized=dict(before=before, after=torch.cuda.is_initialized(),
                               fresh_process=fresh["cuda_initialized"]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from gccnmf_torch import _build, checkpoint, cli, pretrain
    from gccnmf_torch.config import GCCNMFConfig
    from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig, StreamParams
    from gccnmf_torch.ops import stft as stft_ops
    from gccnmf_torch.ops.windows import sqrt_hamming
    from gccnmf_torch.serving import StreamServer, StreamSettings
    from gccnmf_torch.models.offline import GCCNMFEnhancer, GCCNMFSeparator, OfflineConfig
    from gccnmf_torch.models.online import OnlineConfig, OnlineGCCNMFEnhancer
    from gccnmf_torch.ops import gcc, localize, masks
    from gccnmf_torch.models import offline as offline_mod
    from gccnmf_torch.ops import enhance_cuda
    from gccnmf_torch.ops.enhance_cuda import (
        argmax_flips, fold_rows, soft_mask_basis, soft_mask_cuda, soft_mask_plain,
        tf_synthesis_basis, tf_synthesis_cuda, tf_synthesis_plain,
    )
    from gccnmf_torch.ops.frontend_cuda import (
        frontend_basis, stft_gcc_frontend_cuda, stft_gcc_frontend_plain,
    )
    from gccnmf_torch.ops.nmf import kl_divergence, kl_nmf, nmf_init_numpy
    from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda, kl_nmf_plain, q_on_chip
    from gccnmf_torch.ops.synthesis_cuda import (
        idft_rows, masked_synthesis_cuda, masked_synthesis_plain, synthesis_basis,
    )
    from gccnmf_torch.ops.windows import hann_symmetric
    from gccnmf_torch.precision import set_fp32_precision
    from gccnmf_torch.utils import wav

    wrappers = {"stft_gcc_frontend_cuda": stft_gcc_frontend_cuda,
                "kl_nmf_cuda": kl_nmf_cuda, "masked_synthesis_cuda": masked_synthesis_cuda,
                "soft_mask_cuda": soft_mask_cuda, "tf_synthesis_cuda": tf_synthesis_cuda}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    build_s = time.perf_counter() - t0
    hgmma, no_hgmma, simt_tc = hgmma_counts(_build._nvcc(), lib._name)
    require(all(n > 0 for n in hgmma.values()), f"a tensor-core kernel has no HGMMA: {hgmma}")
    require(not no_hgmma, f"tensor-core instantiations without HGMMA: {no_hgmma}")
    require(all(n == 0 for n in simt_tc.values()),
            f"a float32 SIMT kernel runs tensor-core instructions: {simt_tc}")
    ptxas = ptxas_summary(_build.build_log)  # empty when the library was cached
    spills = [k for k, v in ptxas.items() if any(n in k for n in (*NO_SPILL, *SIMT_KERNELS))
              and "0 bytes spill stores, 0 bytes spill loads" not in v]
    require(not spills, f"a tensor-core or SIMT product kernel spills: {spills}")
    notes = ptxas_notes(_build.build_log)
    stalled = {k: v for k, v in notes.items() if any(n in k for n in PIPELINED)}
    require(not stalled, f"ptxas waits for or serialises a pipelined kernel's wgmma: {stalled}")
    emit("build", seconds=round(build_s, 3), library=os.path.relpath(lib._name, ROOT),
         hgmma=hgmma, simt_tensor_core_instructions=simt_tc, ptxas=ptxas, ptxas_notes=notes)

    # ---- 3. kernels against their plain versions ---------------------------
    mix = make_mixture(args.seed, MAIN_BATCH)
    n = mix.shape[-1]
    window = hann_symmetric(WIN)
    f = WIN // 2 + 1
    cos_np, sin_np = gcc.steering_cos_sin(float(SR), f, 1.0, D)
    cos_m, sin_m = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    # built for bf16: the fp32 halves that the float32 rows read, and the
    # tensor-core rows and steering fold
    fbasis = frontend_basis(window, True, dev, "bfloat16", (cos_m, sin_m))
    # built for bf16: the fp32 A and −B that the float32 rows read, and the
    # bf16 rows of the tensor-core iDFT
    sbasis = synthesis_basis(window, HOP / WIN * 2.0, "bfloat16", device=dev)
    t = 1 + (n - WIN) // HOP
    w0_np, h0_np = nmf_init_numpy(f, K, 2 * t)
    rows = []

    def idft_library_ms(md, rows):
        """The yardstick for a synthesis row: its iDFT alone, as one
        torch.matmul of ``rows`` (Z·T, 2F) spectrum rows against the (2F,
        win) basis [A ; −B], in the mode's operand type."""
        dt = torch.float32 if md == "float32" else torch.bfloat16
        x_ = torch.rand((rows, 2 * f), device=dev).to(dt)
        basis_ = torch.cat([sbasis.a, sbasis.b_neg]).to(dt)
        ms = time_ms(torch, lambda: x_ @ basis_)
        del x_, basis_
        return ms, (f"the iDFT alone: ({rows}, 2F) @ (2F, win) as one torch.matmul on {dt} "
                    "operands; no spectra and no overlap-add, so library_ms stays null")

    def fft_library_ms(md, rows):
        """The float32 synthesis rows' second yardstick: the same (rows, F)
        spectra through one ``torch.fft.irfft`` (n = win, cuFFT) times the
        window; nothing for the bf16 rows, whose rounded basis no FFT
        computes."""
        if md != "float32":
            return {}
        x_ = torch.complex(torch.rand((rows, f), device=dev), torch.rand((rows, f), device=dev))
        w_ = torch.as_tensor(window, device=dev)
        ms = time_ms(torch, lambda: torch.fft.irfft(x_, n=WIN) * w_)
        del x_
        return dict(fft_library_ms=ms, fft_library_note=(
            f"the iDFT alone: ({rows}, F) spectra as torch.fft.irfft(n=win) times the window; "
            "no spectra and no overlap-add, so library_ms stays null"))

    def device_ms(fn, keys):
        """Device time (ms) of one ``fn()`` after a warm-up, summed over the
        kernels whose names hold one of ``keys`` (torch.profiler), and by
        key: a kernel's own time, without the wrapper's host time that CUDA
        events around the call include where the card waits for it."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_key = {k: sum(ev.device_time_total for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA and k in ev.key) / 1e3 for k in keys}
        by_key = {k: ms for k, ms in by_key.items() if ms > 0}
        return sum(by_key.values()), by_key

    def frontend_float64(x, basis, cos_, sin_, hop):
        """The float32 front-end's function in float64, the yardstick of its
        coherence planes: the float64 rfft of the windowed frames (conjugated
        as the basis says), |X|, the guarded PHAT coherence and the angular
        spectrogram of (B, 2, n) signals ``x``."""
        frames = x.double().unfold(-1, basis.window.shape[0], hop) * basis.window.double()
        spec = torch.fft.rfft(frames, dim=-1)
        spec = spec.conj() if basis.conjugate else spec
        mag = spec.abs()
        den = mag[:, 0] * mag[:, 1]
        ok = den > 1e-30
        coh = torch.where(ok, spec[:, 0] * spec[:, 1].conj() / torch.where(ok, den, 1.0), 0.0)
        return (spec.real, spec.imag, mag, coh.real, coh.imag,
                coh.real @ cos_.double() + coh.imag @ sin_.double())

    def fft_frontend_library_ms(b, t_, basis, cos_, sin_):
        """The float32 front-end row's second yardstick: the rDFT as one
        ``torch.fft.rfft`` (cuFFT) of the (B·2·T, win) frames times the
        window, plus the angular spectrogram as one ``torch.matmul``."""
        win_, f_ = basis.wcos.shape
        fr = torch.rand((b * 2 * t_, win_), device=dev)
        co = torch.rand((b * t_, 2 * f_), device=dev)
        st = torch.cat([cos_, sin_])
        ms = time_ms(torch, lambda: (torch.fft.rfft(fr * basis.window, dim=-1), co @ st))
        del fr, co, st
        return dict(fft_library_ms=ms, fft_library_note=(
            f"({b * 2 * t_}, win) frames times the window as torch.fft.rfft and ({b * t_}, 2F) "
            "@ (2F, D) as torch.matmul; no |X|, no coherence, so library_ms stays null"))

    def frontend_library_ms(md, b, t_, basis, cos_, sin_):
        """The yardstick for a front-end row: the rDFT as one torch.matmul of
        the (B·2·T, win) frames against the (win, 2F) basis, plus the
        angular spectrogram as one of the (B·T, 2F) coherence rows against
        the (2F, D) steering planes, in the mode's operand type."""
        dt = torch.float32 if md == "float32" else torch.bfloat16
        fr = torch.rand((b * 2 * t_, WIN), device=dev).to(dt)
        wb = torch.cat([basis.wcos, basis.wsin], dim=1).to(dt)
        co = torch.rand((b * t_, 2 * f), device=dev).to(dt)
        st = torch.cat([cos_, sin_]).to(dt)
        ms = time_ms(torch, lambda: (fr @ wb, co @ st))
        del fr, wb, co, st
        return ms, (f"({b * 2 * t_}, win) @ (win, 2F) and ({b * t_}, 2F) @ (2F, D) as "
                    f"torch.matmul on {dt} operands; no |X|, no coherence, so library_ms "
                    "stays null")

    def record(name, mode, b, source, replaces, got, want, tol, kernel_fn, plain_fn,
               flops, nbytes, check_fn=None, err=None, note="", counted="", shape="",
               reps=TIMED_CALLS, **extra):
        """Check ``got`` (a tuple of the kernel's outputs) against the plain
        version's ``want``, rerun the kernel (``check_fn``, default
        ``kernel_fn``) for bit-identity, time both, and keep the row;
        ``counted`` says how ``flops`` was counted; ``shape`` is added to
        the row's name."""
        label = f"{name}[{mode}]" + ("" if b == KERNEL_BATCH else f"@B{b}") + shape
        again = (check_fn or kernel_fn)()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        require(same, f"{label} is not bit-identical across two runs")
        if err is None:
            err, scale = max(max_err(torch, g, w) for g, w in zip(got, want))
            require(err <= tol * scale, f"{label} max abs err {err} > {tol} x {scale}")
        b_ms, b_by = bound(flops, nbytes, mode)
        ms = time_ms(torch, kernel_fn, reps)
        row = dict(name=label, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, ms=ms, tflop_s=flops / ms / 1e9,
                   plain_ms=time_ms(torch, plain_fn, reps), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, library_note="no single PyTorch call computes this "
                   "function", tolerance=note, bit_identical=True, batch=b,
                   kernel=name, mode=mode,
                   bound_basis=(f"{flops:.4g} flop ({counted}) at "
                                f"{PEAK_FLOP_S[mode] / 1e12:g} TFLOP/s, {nbytes:.4g} B at "
                                "3.35 TB/s (H100 SXM data sheet)"),
                   **extra)
        emit("kernel", **row)
        rows.append(row)
        return row

    def check_frontend(x, md, basis, cos_, sin_, hop, shape=""):
        """The front-end kernel in mode ``md`` on the (B, 2, n) signals
        ``x`` against its plain version; returns the kernel's planes. In
        float32 the coherence planes are held against the function in
        float64 (:func:`frontend_float64`), at the same bar: near a bin of
        |X| a thousandth of the median the fp32 GEMM of the plain version
        moves the coherence by more than the bar, which the kernel's FFT,
        nearer the float64 result, cannot match; the row gives both
        distances."""
        kw = dict(hop_size=hop, matmul_dtype=md, plane_dtype=md)
        kfn = lambda: stft_gcc_frontend_cuda(x, basis, cos_, sin_, **kw)  # noqa: E731
        pfn = lambda: stft_gcc_frontend_plain(x, basis, cos_, sin_, **kw)  # noqa: E731
        got, want = kfn(), pfn()
        b, n_ = x.shape[0], x.shape[-1]
        t_, d_ = got[5].shape[-2], cos_.shape[-1]
        psize = 4 if md == "float32" else 2
        dft, counted = dft_flops(b * 2 * t_, WIN, md), DFT_COUNTED[md == "float32"]
        lib_ms, lib_note = frontend_library_ms(md, b, t_, basis, cos_, sin_)
        extra = {}
        if md == "float32":
            exact = frontend_float64(x, basis, cos_, sin_, hop)
            rel = lambda a, e: max_err(torch, a, e)[0] / max_err(torch, a, e)[1]  # noqa: E731
            extra = dict(
                coherence_reference="float64", coherence_vs_plain=max(
                    rel(g, w) for g, w in zip(got[3:5], want[3:5])),
                coherence_vs_float64=max(rel(g, e) for g, e in zip(got[3:5], exact[3:5])),
                plain_coherence_vs_float64=max(rel(w, e) for w, e in zip(want[3:5], exact[3:5])),
                spectrum_vs_float64=max(rel(g, e) for g, e in zip(got[:3], exact[:3])),
                plain_spectrum_vs_float64=max(rel(w, e) for w, e in zip(want[:3], exact[:3])),
                **fft_frontend_library_ms(b, t_, basis, cos_, sin_))
            want = (*want[:3], *(e.float() for e in exact[3:5]), want[5])
            del exact
        total_ms, split_ms = device_ms(kfn, FRONTEND_KERNELS)
        record(
            "stft_gcc_frontend_cuda", md, b, "gccnmf_torch/csrc/frontend.cu",
            "gccnmf_tpu/ops/frontend_pallas.py:111", got, want,
            1e-4 if md == "float32" else 8e-3, kfn, pfn,
            flops=dft + b * 4 * t_ * f * d_, counted=counted + ", angular GEMM",
            nbytes=b * 2 * n_ * 4 + 4 * (basis_len(WIN, md) + 2 * f * d_)
            + b * psize * (3 * 2 * t_ * f + 2 * t_ * f) + b * t_ * d_ * 4,
            note=("1e-4 x max|plain| (the coherence planes: x max|float64|, against the "
                  "function in float64)" if md == "float32"
                  else "8e-3 (one bf16 step) x max|plain|"),
            design="fft" if md == "float32" else "wgmma", gemm_library_ms=lib_ms,
            gemm_library_note=lib_note, device_ms=total_ms, device_ms_by_kernel=split_ms,
            device_note="its kernels' device time in one call (torch.profiler); ms is CUDA "
                        "events around the call, the wrapper's host time included",
            shape=shape, **extra,
        )
        return got

    def check_kernels(b, fe_modes, nmf_modes, syn_modes, nmf_check_iters):
        """Each kernel at batch ``b`` of the reference shapes against its
        plain version. The first front-end mode's planes feed the NMF and
        the attribution, and the first NMF mode's W and H the synthesis, as
        they do on the main path."""
        x = torch.as_tensor(mix[:b], device=dev)
        planes = {md: check_frontend(x, md, fbasis, cos_m, sin_m, HOP) for md in fe_modes}
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
            # the yardstick: one iteration's products (four; three in the
            # turbo mode, one H·Wᵀ) as torch.matmul at this batch, in the
            # mode's operand type, times NMF_ITERS
            turbo = md == "bfloat16_q_simul"
            gemms = 3 if turbo else 4
            dt = torch.float32 if md == "float32" else torch.bfloat16
            hb_, wb_, q_ = (torch.rand(shape, device=dev).to(dt)
                            for shape in ((b, 2 * t, K), (b, f, K), (b, 2 * t, f)))
            products = lambda hb_=hb_, wb_=wb_, q_=q_: (  # noqa: E731
                hb_ @ wb_.transpose(-1, -2), q_ @ wb_, q_.transpose(-1, -2) @ hb_,
                *(() if turbo else (hb_ @ wb_.transpose(-1, -2),)))
            gemm_library_ms = time_ms(torch, products) * NMF_ITERS
            del hb_, wb_, q_, products
            record(
                "kl_nmf_cuda", md, b, "gccnmf_torch/csrc/nmf.cu",
                "gccnmf_tpu/ops/nmf_pallas.py:218", got, None, 0.0,
                lambda md=md: kl_nmf_cuda(v, w0, h0, NMF_ITERS, matmul_dtype=md),
                lambda md=md: kl_nmf_plain(v, w0, h0, NMF_ITERS, matmul_dtype=md),
                flops=2 * gemms * b * 2 * t * f * K * NMF_ITERS,
                counted=f"{gemms} GEMMs of 2·M·F·K per iteration, {NMF_ITERS} iterations",
                nbytes=b * 2 * t * f * v.element_size() + 2 * 4 * b * (f * K + 2 * t * K),
                check_fn=lambda md=md: kl_nmf_cuda(v, w0, h0, nmf_check_iters,
                                                   matmul_dtype=md),
                err=err, note=note, iterations_timed=NMF_ITERS,
                design=("simt2" if md == "float32" else
                        "wgmma_q_on_chip" if q_on_chip(md, K) else "wgmma"),
                gemm_library_ms=gemm_library_ms,
                gemm_library_note=(f"H·Wᵀ {'once' if turbo else 'twice'}, Q·W, Qᵀ·H as "
                                   f"torch.matmul on {dt} operands at B = {b}, times "
                                   f"{NMF_ITERS}; not the same function (no ratio, updates "
                                   "or sums), so library_ms stays null"),
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
            dft, counted = dft_flops(b * SOURCES * 2 * t, WIN, md), DFT_COUNTED[md == "float32"]
            lib_ms, lib_note = idft_library_ms(md, b * SOURCES * 2 * t)
            record(
                "masked_synthesis_cuda", md, b, "gccnmf_torch/csrc/synthesis.cu",
                "gccnmf_tpu/ops/synthesis_pallas.py:140", (kfn(),), (pfn(),), tol, kfn, pfn,
                flops=2 * b * SOURCES * 2 * t * f * K + dft, counted="W·H GEMM, " + counted,
                nbytes=b * (2 * 2 * t * f * psize + t * K * 4 + f * K * 4 + 2 * t * K * 4)
                + 4 * basis_len(WIN, md) + b * SOURCES * 2 * (t - 1) * HOP * 4,
                check_fn=lambda kfn=kfn: (kfn(),),
                note=("1e-4" if md == "float32" else "1e-2 (bf16 operands)") + " x max|plain|",
                design="fft" if md == "float32" else "wgmma", gemm_library_ms=lib_ms,
                gemm_library_note=lib_note, **fft_library_ms(md, b * SOURCES * 2 * t),
            )

    # every mode at batch 2, the NMF checked after 15 iterations
    check_kernels(KERNEL_BATCH, ("float32", "bfloat16"),
                  ("float32", "bfloat16", "bfloat16_q", "bfloat16_q_simul"),
                  ("float32", "bfloat16"), NMF_CHECK_ITERS)
    # the default config's modes and the turbo NMF at the batched main path's
    # shapes, the NMF checked at its full 100 iterations
    check_kernels(MAIN_BATCH, ("bfloat16",), ("bfloat16_q", "bfloat16_q_simul"), ("bfloat16",),
                  NMF_ITERS)
    torch.cuda.empty_cache()

    # the enhancement kernels on bench.py's enhancement configuration, with
    # a dictionary that the NMF kernel learns on the first mixture's |X|
    cos_e, sin_e = (torch.as_tensor(m, device=dev)
                    for m in gcc.steering_cos_sin(float(SR), f, ENH_MIC_M, D))
    ebasis = frontend_basis(window, True, dev, "bfloat16", (cos_e, sin_e))
    fe32 = stft_gcc_frontend_cuda(torch.as_tensor(mix[:1], device=dev), ebasis, cos_e, sin_e,
                                  hop_size=HOP, matmul_dtype="float32", plane_dtype="float32")
    w_enh = kl_nmf_cuda(fe32[2].reshape(1, 2 * t, f), torch.as_tensor(w0_np, device=dev)[None],
                        torch.as_tensor(h0_np, device=dev)[None], NMF_ITERS,
                        matmul_dtype="float32")[0][0]
    require(bool(torch.isfinite(w_enh).all()), "the learned dictionary is not finite")
    tbasis = tf_synthesis_basis(w_enh, window, HOP / WIN * 2.0, "bfloat16", device=dev)

    def check_enhance_kernels(b, modes, x=None, hop=HOP, fe=None, w=None, tb=None,
                              mask=(ENH_EPS, ENH_BETA, ENH_FLOOR), shape=""):
        """The soft mask and the Wiener synthesis at batch ``b`` against
        their plain versions, on the front-end kernel's planes in each mode
        and the utterances' own target TDOAs, as the enhancer feeds them.
        By default on the first ``b`` mixtures at the enhancement
        configuration; given ``x`` (B, 2, n), the hop, the front-end's
        ``(basis, cos, sin)``, the dictionary, the Wiener basis and the mask
        parameters of another enhancer, also the front-end kernel, each row
        named with ``shape``."""
        if x is None:
            x = torch.as_tensor(mix[:b], device=dev)
        basis, cos_, sin_ = fe or (ebasis, cos_e, sin_e)
        w, tb = (w_enh, tbasis) if w is None else (w, tb)
        k_, d_ = w.shape[-1], cos_.shape[-1]
        for md in modes:
            if fe is None:
                sre, sim, _, cre, cim, ang = stft_gcc_frontend_cuda(
                    x, basis, cos_, sin_, hop_size=hop, matmul_dtype=md, plane_dtype=md)
            else:
                sre, sim, _, cre, cim, ang = check_frontend(x, md, basis, cos_, sin_, hop, shape)
            t_ = ang.shape[-2]
            tgt = torch.argmax(gcc.mean_angular_spectrum(ang), dim=-1)
            mb = soft_mask_basis(cos_, sin_, w, md)
            margs = (cre, cim, mb, tgt, *mask)
            kfn = lambda margs=margs, md=md: soft_mask_cuda(*margs, matmul_dtype=md,
                                                            return_argmax=True)
            got = kfn()
            want = soft_mask_plain(*margs, matmul_dtype=md)
            flipped, gap, scale = argmax_flips(cre, cim, mb, got[1], matmul_dtype=md)
            flips = int(flipped.sum())
            require(gap <= TIE_TOL * scale,
                    f"soft_mask_cuda[{md}]@B{b}{shape}: an argmax flip {gap} > {TIE_TOL} x {scale}")
            ulps = int((got[0].view(torch.int32).long() - want.view(torch.int32).long())
                       .abs()[~flipped].max())
            require(ulps <= MASK_ULPS,
                    f"soft_mask_cuda[{md}]@B{b}{shape}: masks {ulps} ulps apart where the argmax "
                    "agrees")
            agree = float(torch.isclose(got[0], want, rtol=1e-6, atol=0.0).float().mean())
            require(agree >= MASK_AGREE[md],
                    f"soft_mask_cuda[{md}]@B{b}{shape}: masks agree on {agree} < {MASK_AGREE[md]}")
            psize = 4 if md == "float32" else 2
            # the yardstick: the same scores as one torch.matmul of the
            # [Re c | Im c] rows against the (2F, D·K) fold, in the mode's
            # operand type
            dt = torch.float32 if md == "float32" else torch.bfloat16
            rows_ = idft_rows(cre, cim, f, dt)
            fold_ = fold_rows(mb.cw.to(dt), mb.sw.to(dt))[..., :rows_.shape[1]].reshape(d_ * k_, -1)
            gemm_library_ms = time_ms(torch, lambda rows_=rows_, fold_=fold_: rows_ @ fold_.T)
            del rows_, fold_
            if md == "float32":  # Re c·cos_d + Im c·sin_d, then one GEMM against W
                flops, counted = 2 * b * t_ * f * d_ * k_ + 3 * b * t_ * f * d_, "Y_d, then Y_d·W"
            else:  # JAX rounds the folded product bf16(cos_d·W): no cheaper form
                flops, counted = 4 * b * t_ * f * d_ * k_, "GEMMs on the bf16-rounded fold"
            record(
                "soft_mask_cuda", md, b, "gccnmf_torch/csrc/enhance.cu",
                "gccnmf_tpu/ops/enhance_pallas.py:111", got, None, 0.0,
                lambda margs=margs, md=md: soft_mask_cuda(*margs, matmul_dtype=md),
                lambda margs=margs, md=md: soft_mask_plain(*margs, matmul_dtype=md),
                flops=flops, counted=counted,
                nbytes=(b * 2 * t_ * f * psize + 4 * (f * k_ + 2 * f * d_) + b * 16
                        + b * t_ * k_ * 4),
                check_fn=kfn, err=max_err(torch, got[0], want)[0],
                note=(f"argmax flips only at near-ties ({flips} of {flipped.numel()}; plain "
                      f"score at the kernel's TDOA within {gap:.3g} <= {TIE_TOL} x {scale:.4g} "
                      f"of the plain max); masks within {ulps} <= {MASK_ULPS} fp32 ulps where "
                      f"the argmax agrees, and agree on {agree:.6f} >= {MASK_AGREE[md]} of "
                      "(t, k) at rtol 1e-6; max_abs_err is over all (t, k), flips included"),
                argmax_flips=flips, mask_ulps=ulps, mask_agreement=agree,
                design="simt2" if md == "float32" else "wgmma_tma_cluster",
                gemm_library_ms=gemm_library_ms,
                gemm_library_note=(f"[Re c | Im c] rows @ the (2F, D·K) fold as one torch.matmul "
                                   f"on {dt} operands at B = {b}; the scores alone (no argmax, "
                                   "no mask), so library_ms stays null"),
                shape=shape,
            )
            hm = got[0]
            kfn = lambda sre=sre, sim=sim, hm=hm, md=md: tf_synthesis_cuda(
                sre, sim, hm, tb, hop_size=hop, matmul_dtype=md)
            pfn = lambda sre=sre, sim=sim, hm=hm, md=md: tf_synthesis_plain(
                sre, sim, hm, tb, hop_size=hop, matmul_dtype=md)
            dft, counted = dft_flops(b * 2 * t_, WIN, md), DFT_COUNTED[md == "float32"]
            lib_ms, lib_note = idft_library_ms(md, b * 2 * t_)
            record(
                "tf_synthesis_cuda", md, b, "gccnmf_torch/csrc/enhance.cu",
                "gccnmf_tpu/ops/enhance_pallas.py:356", (kfn(),), (pfn(),),
                1e-4 if md == "float32" else 1e-2, kfn, pfn,
                flops=2 * b * t_ * k_ * f + dft, counted="Wiener GEMM, " + counted,
                nbytes=b * 2 * 2 * t_ * f * psize + b * t_ * k_ * 4 + k_ * f * 4
                + 4 * basis_len(WIN, md) + b * 2 * (t_ - 1) * hop * 4,
                check_fn=lambda kfn=kfn: (kfn(),),
                note=("1e-4" if md == "float32" else "1e-2 (bf16 operands)") + " x max|plain|",
                design="fft" if md == "float32" else "wgmma", gemm_library_ms=lib_ms,
                gemm_library_note=lib_note, shape=shape, **fft_library_ms(md, b * 2 * t_),
            )

    check_enhance_kernels(KERNEL_BATCH, ("float32", "bfloat16"))
    check_enhance_kernels(MAIN_BATCH, ("bfloat16",))
    torch.cuda.empty_cache()

    # kernel 4 bf16 at the enhancement cell's shape (16 mixtures of 60 s, F =
    # 513, 64 TDOAs over 10 cm, K = 1,024; seeded planes and dictionary):
    # the first two mixtures against the plain version at the bars above
    # (its scores at all 16 would take 31 GB), which must also be the
    # batch's first two bit for bit; then the batch timed
    rng_c = np.random.default_rng(args.seed + 26)
    cb, ct, ck, cd = MAIN_BATCH, 7493, 1024, 64
    cre_c, cim_c = (torch.as_tensor(rng_c.standard_normal((cb, ct, f)), dtype=torch.bfloat16,
                                    device=dev) for _ in range(2))
    cos_c, sin_c = gcc.steering_cos_sin(float(SR), f, ENH_MIC_M, cd)
    w_c = torch.as_tensor(rng_c.random((f, ck)) ** 3 + 1e-3, dtype=torch.float32, device=dev)
    mb_c = soft_mask_basis(cos_c, sin_c, w_c, "bfloat16")
    tgt_c = torch.as_tensor(rng_c.integers(0, cd, cb), device=dev)
    cargs = (cre_c, cim_c, mb_c, tgt_c, ENH_EPS, ENH_BETA, ENH_FLOOR)
    calls0 = (soft_mask_cuda.launches, soft_mask_cuda.multicast)
    first = soft_mask_cuda(*cargs)
    require(torch.equal(first, soft_mask_cuda(*cargs)),
            "soft_mask_cuda at the cell's shape is not bit-identical across two runs")
    name = f"soft_mask_cuda[bfloat16]@B{{}} T={ct} K={ck} D={cd}"
    two = (cre_c[:2].clone(), cim_c[:2].clone(), mb_c, tgt_c[:2], ENH_EPS, ENH_BETA, ENH_FLOOR)
    got, arg = soft_mask_cuda(*two, return_argmax=True)
    require(torch.equal(got, first[:2]),
            f"{name.format(2)}: not the batch of {cb}'s first two mixtures bit for bit")
    want = soft_mask_plain(*two)
    flipped, gap, scale = argmax_flips(two[0], two[1], mb_c, arg)
    flips = int(flipped.sum())
    require(gap <= TIE_TOL * scale,
            f"{name.format(2)}: an argmax flip {gap} > {TIE_TOL} x {scale}")
    ulps = int((got.view(torch.int32).long() - want.view(torch.int32).long())
               .abs()[~flipped].max())
    require(ulps <= MASK_ULPS, f"{name.format(2)}: masks {ulps} ulps apart where the argmax agrees")
    agree = float(torch.isclose(got, want, rtol=1e-6, atol=0.0).float().mean())
    require(agree >= MASK_AGREE["bfloat16"],
            f"{name.format(2)}: masks agree on {agree} < {MASK_AGREE['bfloat16']}")
    err2 = max_err(torch, got, want)[0]
    del got, arg, want, flipped
    ms2 = time_ms(torch, lambda: soft_mask_cuda(*two))
    plain_ms2 = time_ms(torch, lambda: soft_mask_plain(*two), reps=2)
    cflops = 4 * ct * f * cd * ck  # a mixture's
    cbytes = 2 * ct * f * 2 + ct * ck * 4  # a mixture's planes and mask
    fold_bytes = cd * ck * 2 * f * 2
    for b_, ms_, extra in ((2, ms2, dict(plain_ms=plain_ms2, max_abs_err=err2, argmax_flips=flips,
                                           mask_ulps=ulps, mask_agreement=agree)),
                           (cb, time_ms(torch, lambda: soft_mask_cuda(*cargs)),
                            dict(plain_ms=None,
                                 sha256=hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest(),
                                 launches=soft_mask_cuda.launches - calls0[0],
                                 multicast=soft_mask_cuda.multicast - calls0[1]))):
        bound_ms, bound_by = bound(b_ * cflops, b_ * cbytes + fold_bytes, "bfloat16")
        emit("kernel", name=name.format(b_), route="cuda", source="gccnmf_torch/csrc/scores.cu",
             kernel="soft_mask_cuda", mode="bfloat16", batch=b_, ms=ms_,
             tflop_s=b_ * cflops / ms_ / 1e9, bound_ms=bound_ms, bound_by=bound_by,
             design="wgmma_tma_cluster", **extra)
    require(soft_mask_cuda.multicast - calls0[1] == soft_mask_cuda.launches - calls0[0],
            f"{name.format(cb)}: a bf16 call left the cluster route")
    del cre_c, cim_c, cargs, two, first
    torch.cuda.empty_cache()

    # ---- 4. the main path: GCCNMFSeparator() -------------------------------
    sep_kernels = ("stft_gcc_frontend_cuda", "kl_nmf_cuda", "masked_synthesis_cuda")

    def run_paths(paths):
        """Each ``(name, fn)`` of ``paths`` after a warm-up call, then
        TIMED_CALLS times with the launch counters set to 0 just before each
        call and read just after it: per path the last result, the median
        wall seconds (``s_<name>``), every call's seconds and the launches
        of one call, which every call must repeat."""
        for _, fn in paths:
            fn()  # warm-up: allocator, cuBLAS handles
        out = dict(counts={}, seconds={})
        for path, fn in paths:
            times, per_call = [], []
            for _ in range(TIMED_CALLS):
                reset_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out[path] = fn()
                times.append(time.perf_counter() - t1)
                per_call.append(counts())
            require(all(c == per_call[0] for c in per_call),
                    f"{path}: launch counts differ between calls: {per_call}")
            out["s_" + path], out["seconds"][path] = statistics.median(times), times
            out["counts"][path] = per_call[0]
        return out

    def drive(cfg, batch: bool):
        """``separate`` (and ``separate_batch`` when ``batch``), timed and
        counted by :func:`run_paths`."""
        sep = GCCNMFSeparator(cfg)
        out = run_paths([("separate", lambda: sep.separate(mix[0]))]
                        + ([("separate_batch", lambda: sep.separate_batch(mix))] if batch else []))
        for path, c in out["counts"].items():
            require(all(c[k] > 0 for k in sep_kernels),
                    f"{cfg.nmf_matmul_dtype} {path}: a kernel never launched: {c}")
        out["sep"], out["mode"] = sep, cfg.nmf_matmul_dtype
        return out

    n_out = (t - 1) * HOP

    def hold_batch(run):
        """Every utterance of ``run``'s separate_batch against separate() of
        it alone: the same kernels at B = 1, so this holds the B = 16
        buffers element by element."""
        est, targets = run["separate_batch"]
        single = run["separate"]
        mode = run["mode"]
        require(single["estimates"].shape == (SOURCES, 2, n_out), f"{mode} separate: shape")
        require(est.shape == (MAIN_BATCH, SOURCES, 2, n_out), f"{mode} separate_batch: shape")
        require(np.isfinite(single["estimates"]).all() and np.isfinite(est).all(),
                f"{mode}: non-finite estimates")
        batch_snr, batch_err, scale = [], 0.0, 0.0
        for i in range(MAIN_BATCH):
            one = single if i == 0 else run["sep"].separate(mix[i])
            require(list(targets[i]) == one["target_tdoa_indexes"],
                    f"{mode} separate_batch[{i}] targets {list(targets[i])} != "
                    f"{one['target_tdoa_indexes']}")
            batch_err = max(batch_err, float(np.abs(est[i] - one["estimates"]).max()))
            scale = max(scale, float(np.abs(one["estimates"]).max()))
            batch_snr.append(min(snr_db(r, e) for r, e in zip(one["estimates"], est[i])))
        require(batch_err <= BATCH_TOL * scale,
                f"{mode} separate_batch against separate: max abs err {batch_err} > "
                f"{BATCH_TOL} x {scale}")
        return dict(max_abs_err=batch_err, bar=f"{BATCH_TOL} x {scale}",
                    min_snr_db=min(batch_snr))

    def path_fields(run):
        return dict(targets=run["separate"]["target_tdoa_indexes"], launches=run["counts"],
                    separate_s=run["s_separate"],
                    separate_audio_s_per_s=SECONDS / run["s_separate"], batch=MAIN_BATCH,
                    separate_batch_s=run["s_separate_batch"],
                    separate_batch_audio_s_per_s=MAIN_BATCH * SECONDS / run["s_separate_batch"],
                    seconds_per_call=run["seconds"], batch_vs_separate=hold_batch(run))

    main = drive(OfflineConfig(), batch=True)
    est, targets = main["separate_batch"]
    single = main["separate"]
    emit("separate", device=kind, nvidia_smi=smi, config="OfflineConfig() (bfloat16_q)",
         **path_fields(main))

    bf16 = drive(OfflineConfig(nmf_matmul_dtype="bfloat16"), batch=False)
    require(bf16["separate"]["target_tdoa_indexes"] == single["target_tdoa_indexes"],
            "bfloat16 mode picks other targets")
    emit("mode", nmf_matmul_dtype="bfloat16", launches=bf16["counts"],
         separate_s=bf16["s_separate"], targets=bf16["separate"]["target_tdoa_indexes"])

    # ---- turbo: the simultaneous NMF updates on both separation paths -----
    turbo = drive(OfflineConfig(nmf_matmul_dtype="bfloat16_q_simul"), batch=True)
    fields = path_fields(turbo)
    # localization reads the angular spectrum, not the NMF: the same targets
    require(fields["targets"] == single["target_tdoa_indexes"]
            and np.array_equal(turbo["separate_batch"][1], targets),
            f"turbo targets {fields['targets']} != bfloat16_q {single['target_tdoa_indexes']}")
    emit("turbo", device=kind, nvidia_smi=smi,
         config="OfflineConfig(nmf_matmul_dtype='bfloat16_q_simul')", **fields,
         snr_db_vs_bfloat16_q=[snr_db(r, e) for r, e in zip(single["estimates"],
                                                            turbo["separate"]["estimates"])],
         note="a different algorithm from bfloat16_q: snr_db_vs_bfloat16_q is a reading, "
              "not a bar")
    del turbo["sep"]

    # ---- throughput: source counting on the device, pipelined chunks -------
    auto_sep = GCCNMFSeparator(OfflineConfig(num_sources=None))
    auto = run_paths([("separate_batch_auto",
                       lambda: auto_sep.separate_batch(mix, max_sources=AUTO_MAX))])
    a_est, a_targets, a_counts = auto["separate_batch_auto"]
    require(all(auto["counts"]["separate_batch_auto"][k] > 0 for k in sep_kernels),
            f"separate_batch_auto: a kernel never launched: {auto['counts']}")
    require(a_est.shape == (MAIN_BATCH, AUTO_MAX, 2, n_out) and np.isfinite(a_est).all(),
            "separate_batch_auto: wrong shape or non-finite")
    host_agree = 0
    for i, c in enumerate(a_counts):
        require(1 <= c <= AUTO_MAX and all(a_est[i, r].any() for r in range(c))
                and not a_est[i, c:].any(),
                f"separate_batch_auto[{i}]: count {c}, silent rows or loud pads")
        host = auto_sep.separate(mix[i])["target_tdoa_indexes"]
        host_agree += list(a_targets[i][:c]) == host
    # the device 2-means against the same op on the CPU, on the card's spectra
    ang = stft_gcc_frontend_cuda(torch.as_tensor(mix, device=dev), fbasis, cos_m, sin_m,
                                 hop_size=HOP, matmul_dtype="bfloat16",
                                 plane_dtype="bfloat16")[5]
    mean_ang = gcc.mean_angular_spectrum(ang)
    got_t, got_c = localize.auto_count_targets(mean_ang, AUTO_MAX)
    want_t, want_c = localize.auto_count_targets(mean_ang.cpu(), AUTO_MAX)
    require(torch.equal(got_t.cpu(), want_t) and torch.equal(got_c.cpu(), want_c)
            and np.array_equal(got_c.cpu().numpy(), a_counts),
            "auto_count_targets on the card differs from the CPU")
    del auto_sep, a_est

    sep = main["sep"]
    chunks = [make_mixture(args.seed + 1 + i, MAIN_BATCH) for i in range(CHUNKS)]
    # the int16 program's input is PCM, as a 16-bit WAV reader gives it; its
    # reference is separate_batch of the same samples as floats, quantized
    # on the way out as the program quantizes
    pcm = [np.clip(c * 32768.0, -32768, 32767).astype(np.int16) for c in chunks]
    pipelined = {}
    for io_dtype, inputs, refs in (
            ("float32", chunks, chunks),
            ("int16", pcm, [c / np.float32(32768) for c in pcm])):
        run = run_paths([
            ("separate_batches", lambda io_dtype=io_dtype, inputs=inputs: list(
                sep.separate_batches(inputs, io_dtype=io_dtype))),
            ("separate_batch_serial", lambda refs=refs: [sep.separate_batch(r) for r in refs])])
        c = run["counts"]["separate_batches"]
        require(all(c[k] == CHUNKS for k in sep_kernels),
                f"separate_batches ({io_dtype}): launches {c}, want {CHUNKS} of each")
        err, scale = 0.0, 0.0
        for (got_e, got_t), (want_e, want_t) in zip(run["separate_batches"],
                                                    run["separate_batch_serial"]):
            if io_dtype == "int16":
                want_e = np.trunc(np.clip(want_e * 32768.0, -32768, 32767)) / np.float32(32768)
            require(np.array_equal(got_t, want_t),
                    f"separate_batches ({io_dtype}): targets differ")
            err = max(err, float(np.abs(got_e - want_e).max()))
            scale = max(scale, float(np.abs(want_e).max()))
        require(err <= BATCH_TOL * scale,
                f"separate_batches ({io_dtype}) against separate_batch: {err} > "
                f"{BATCH_TOL} x {scale}")
        audio_s = CHUNKS * MAIN_BATCH * SECONDS
        pipelined[io_dtype] = dict(
            launches=c, seconds=run["s_separate_batches"],
            audio_s_per_s=audio_s / run["s_separate_batches"],
            serial_separate_batch_s=run["s_separate_batch_serial"],
            serial_audio_s_per_s=audio_s / run["s_separate_batch_serial"],
            seconds_per_call=run["seconds"],
            vs_separate_batch=dict(max_abs_err=err, bar=f"{BATCH_TOL} x {scale}"))
    emit("throughput", device=kind, nvidia_smi=smi, config="OfflineConfig()",
         separate_batch_auto=dict(
             max_sources=AUTO_MAX, counts=a_counts.tolist(), launches=auto["counts"],
             seconds=auto["s_separate_batch_auto"],
             audio_s_per_s=MAIN_BATCH * SECONDS / auto["s_separate_batch_auto"],
             host_path_agrees=f"{host_agree} of {MAIN_BATCH}"),
         separate_batches=dict(chunks=CHUNKS, batch=MAIN_BATCH, **pipelined))

    # ---- cli: python -m gccnmf_torch.cli on a seeded WAV -------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke_mix.wav")
        wav.write_wav(mix[0], path, SR)
        out = io.StringIO()
        reset_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.separate_main([path, "--turbo", "--auto-sources"])
        cli_s = time.perf_counter() - t1
        c = counts()
        info = json.loads(out.getvalue().strip().splitlines()[-1])
        require(rc == 0 and len(info["outputs"]) == len(info["target_tdoa_indexes"]) >= 1,
                f"cli: {info}")
        require(all(c[k] > 0 for k in sep_kernels), f"cli: a kernel never launched: {c}")
        for p in info["outputs"]:
            x, sr = wav.read_wav(p)
            require(sr == SR and x.shape == (2, n_out) and np.isfinite(x).all()
                    and np.abs(x).max() > 0, f"cli: {os.path.basename(p)} {x.shape}")
    emit("cli", argv="smoke_mix.wav --turbo --auto-sources", seconds=cli_s, launches=c,
         targets=info["target_tdoa_indexes"],
         outputs=[os.path.basename(p) for p in info["outputs"]])
    del main["sep"], bf16["sep"]

    # ---- 5. float32 parity: kernels against the plain torch path ----------
    cfg32 = OfflineConfig(nmf_matmul_dtype="float32")
    f32 = drive(cfg32, batch=False)
    del f32["sep"]
    plain = GCCNMFSeparator(dataclasses.replace(
        cfg32, nmf_backend="torch", synthesis_backend="torch", frontend_backend="torch"
    )).separate(mix[0])
    got, want = f32["separate"], plain
    require(got["target_tdoa_indexes"] == want["target_tdoa_indexes"],
            f"parity targets {got['target_tdoa_indexes']} != {want['target_tdoa_indexes']}")
    snrs = [snr_db(r, e) for r, e in zip(want["estimates"], got["estimates"])]
    require(min(snrs) > 25.0, f"parity SNR {snrs}")
    emit("parity", nmf_matmul_dtype="float32", targets=got["target_tdoa_indexes"],
         snr_db=snrs, launches=f32["counts"], separate_s=f32["s_separate"],
         separate_audio_s_per_s=SECONDS / f32["s_separate"],
         mask_agreement=float((got["coefficient_masks"] == want["coefficient_masks"]).mean()))

    # ---- 6. enhancement: GCCNMFEnhancer ------------------------------------
    cfg_enh = OfflineConfig(mic_separation_m=ENH_MIC_M, num_tdoas=D, dictionary_size=K)
    w_enh_np = w_enh.cpu().numpy()
    enh_kernels = ("stft_gcc_frontend_cuda", "soft_mask_cuda", "tf_synthesis_cuda")

    def drive_enhance(cfg, batch: bool, num_h_updates: int = 0):
        """``enhance`` of one mixture (and of the batch when ``batch``),
        timed and counted by :func:`run_paths`."""
        enh = GCCNMFEnhancer(w_enh_np, cfg, num_h_updates=num_h_updates)
        out = run_paths([("enhance", lambda: enh.enhance(mix[0]))]
                        + ([("enhance_batch", lambda: enh.enhance(mix))] if batch else []))
        out.update(enh=enh, mode=cfg.nmf_matmul_dtype)
        return out

    n_enh = (t - 1) * HOP
    enh_main = drive_enhance(cfg_enh, batch=True)
    one, many = enh_main["enhance"], enh_main["enhance_batch"]
    for path, c in enh_main["counts"].items():
        require(all(c[k] > 0 for k in enh_kernels), f"{path}: a kernel never launched: {c}")
    require(one["enhanced"].shape == (2, n_enh) and many["enhanced"].shape
            == (MAIN_BATCH, 2, n_enh), "enhance: wrong shape")
    require(np.isfinite(one["enhanced"]).all() and np.isfinite(many["enhanced"]).all(),
            "enhance: non-finite output")
    enh_err, enh_scale = 0.0, 0.0
    for i in range(MAIN_BATCH):
        single_i = one if i == 0 else enh_main["enh"].enhance(mix[i])
        require(int(many["target_tdoa_index"][i]) == int(single_i["target_tdoa_index"]),
                f"enhance batch[{i}] target {many['target_tdoa_index'][i]} != "
                f"{single_i['target_tdoa_index']}")
        enh_err = max(enh_err, float(np.abs(many["enhanced"][i] - single_i["enhanced"]).max()))
        enh_scale = max(enh_scale, float(np.abs(single_i["enhanced"]).max()))
    require(enh_err <= BATCH_TOL * enh_scale,
            f"enhance batch against single: max abs err {enh_err} > {BATCH_TOL} x {enh_scale}")
    # the soft mask's TDOA split: at B = 1 the (rows × atoms) tiles alone
    # give too few blocks to fill the card, so the wrapper splits the TDOAs
    # across blocks. The kernel at B = 1 and enhance(mix[0]) with the split
    # and with one chunk of all D TDOAs, in the order split, whole, whole,
    # split; both give the same mask
    _, _, _, cre1, cim1, ang1 = stft_gcc_frontend_cuda(
        torch.as_tensor(mix[:1], device=dev), ebasis, cos_e, sin_e, hop_size=HOP,
        matmul_dtype="bfloat16", plane_dtype="bfloat16")
    margs1 = (cre1, cim1, soft_mask_basis(cos_e, sin_e, w_enh, "bfloat16"),
              torch.argmax(gcc.mean_angular_spectrum(ang1), dim=-1), ENH_EPS, ENH_BETA,
              ENH_FLOOR)
    require(torch.equal(soft_mask_cuda(*margs1), soft_mask_cuda(*margs1, tdoa_chunk=D)),
            "soft_mask_cuda: the TDOA split changes the mask")
    split = {"split": [], "whole": []}
    for name, chunk in (("split", None), ("whole", D), ("whole", D), ("split", None)):
        offline_mod.soft_mask_cuda = functools.partial(soft_mask_cuda, tdoa_chunk=chunk)
        try:
            split[name].append((
                time_ms(torch, lambda chunk=chunk: soft_mask_cuda(*margs1, tdoa_chunk=chunk)),
                run_paths([("enhance", lambda: enh_main["enh"].enhance(mix[0]))])["s_enhance"]
                * 1e3))
        finally:
            offline_mod.soft_mask_cuda = soft_mask_cuda
    emit("tdoa_split", device=kind, nvidia_smi=smi, batch=1, order="split, whole, whole, split",
         split_chunk=enhance_cuda._tdoa_chunk(
             cre1.shape[1], K, D, torch.cuda.get_device_properties(dev).multi_processor_count,
             True),
         soft_mask_ms={k: [r[0] for r in v] for k, v in split.items()},
         enhance_ms={k: [r[1] for r in v] for k, v in split.items()})
    del enh_main["enh"], margs1
    enh_h = drive_enhance(cfg_enh, batch=False, num_h_updates=2)
    del enh_h["enh"]
    hc = enh_h["counts"]["enhance"]
    # the H-update tail is JAX's XLA tail: the front-end kernel alone
    require(hc["stft_gcc_frontend_cuda"] > 0 and hc["soft_mask_cuda"] == 0
            and hc["tf_synthesis_cuda"] == 0, f"enhance with H updates: launches {hc}")
    require(np.isfinite(enh_h["enhance"]["enhanced"]).all(), "enhance with H updates: non-finite")
    emit("enhance", device=kind, nvidia_smi=smi,
         config=f"OfflineConfig(mic_separation_m={ENH_MIC_M}, num_tdoas={D}, "
                f"dictionary_size={K}) (bfloat16_q)",
         target=int(one["target_tdoa_index"]), launches=enh_main["counts"],
         enhance_s=enh_main["s_enhance"],
         enhance_audio_s_per_s=SECONDS / enh_main["s_enhance"], batch=MAIN_BATCH,
         enhance_batch_s=enh_main["s_enhance_batch"],
         enhance_batch_audio_s_per_s=MAIN_BATCH * SECONDS / enh_main["s_enhance_batch"],
         seconds_per_call=enh_main["seconds"],
         batch_vs_single=dict(max_abs_err=enh_err, bar=f"{BATCH_TOL} x {enh_scale}"),
         h_updates=dict(num_h_updates=2, launches=hc, enhance_s=enh_h["s_enhance"]))

    # float32: the kernels against the plain torch path on the card
    cfg_enh32 = dataclasses.replace(cfg_enh, nmf_matmul_dtype="float32")
    enh32 = {}
    for nh in (0, 2):
        enh32[nh] = drive_enhance(cfg_enh32, batch=False, num_h_updates=nh)
        del enh32[nh]["enh"]
        got = enh32[nh]["enhance"]
        want = GCCNMFEnhancer(w_enh_np, dataclasses.replace(
            cfg_enh32, synthesis_backend="torch", frontend_backend="torch"),
            num_h_updates=nh).enhance(mix[0])
        require(int(got["target_tdoa_index"]) == int(want["target_tdoa_index"]),
                f"enhance parity (H updates {nh}): target {got['target_tdoa_index']} != "
                f"{want['target_tdoa_index']}")
        snrs = [snr_db(r, e) for r, e in zip(want["enhanced"], got["enhanced"])]
        require(min(snrs) > 25.0, f"enhance parity (H updates {nh}): SNR {snrs}")
        emit("enhance_parity", nmf_matmul_dtype="float32", num_h_updates=nh,
             target=int(got["target_tdoa_index"]), snr_db=snrs,
             launches=enh32[nh]["counts"]["enhance"], enhance_s=enh32[nh]["s_enhance"],
             enhance_audio_s_per_s=SECONDS / enh32[nh]["s_enhance"])

    # ---- 7. where the time goes: torch.profiler ---------------------------
    def profile_call(call, fn, stages):
        """Device time by stage, the top kernels, the device's launches
        (kernels and copies) and the idle share of one ``fn()`` after a warm-up, and the host's CUDA runtime calls by time
        (a wait for the card shows as a synchronize); ``stages`` maps a
        stage to substrings of its kernels' names. Busy time sums every
        stream, so copies that overlap the compute count twice."""
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        by_stage = dict.fromkeys([*stages, "other"], 0.0)
        top, host, launches = [], [], 0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                if ev.key.startswith("cuda"):  # the runtime API, on the host
                    host.append((ev.self_cpu_time_total / 1e3, ev.key, ev.count))
                continue
            ms = ev.device_time_total / 1e3
            launches += ev.count
            stage = next((s for s, keys in stages.items() if any(k in ev.key for k in keys)),
                         "other")
            by_stage[stage] += ms
            top.append((ms, ev.key[:80], ev.count))
        busy = sum(by_stage.values())
        emit("profile", call=call, wall_ms=wall_ms,
             device_busy_ms=busy if busy else "not measured", device_ms_by_stage=by_stage,
             idle_share=(1.0 - busy / wall_ms) if busy else "not measured",
             device_launches=launches,
             top_kernels=[dict(ms=m, name=k, calls=c) for m, k, c in sorted(top)[::-1][:16]],
             host_cuda_calls=[dict(ms=m, name=k, calls=c) for m, k, c in sorted(host)[::-1][:6]])

    sep = GCCNMFSeparator(OfflineConfig())
    sep_stages = {"kl_nmf_cuda products": ("wh_ratio", "h_update", "qth_split"),
                  "kl_nmf_cuda small launches": ("w_update", "col_reduce", "renorm", "gain",
                                                 "v_sum"),
                  "stft_gcc_frontend_cuda": FRONTEND_KERNELS,
                  "masked_synthesis_cuda": ("spectra_kernel", "frames_kernel", "ola_kernel"),
                  "H2D copies": ("Memcpy HtoD",), "D2H copies": ("Memcpy DtoH",)}
    profile_call(f"separate_batch (B={MAIN_BATCH}, OfflineConfig())",
                 lambda: sep.separate_batch(mix), sep_stages)
    profile_call(f"separate_batches (1 chunk of B={MAIN_BATCH}, OfflineConfig())",
                 lambda: list(sep.separate_batches([mix])), sep_stages)
    profile_call(f"separate_batches ({CHUNKS} chunks of B={MAIN_BATCH}, OfflineConfig())",
                 lambda: list(sep.separate_batches(chunks)), sep_stages)
    sep = GCCNMFSeparator(OfflineConfig(nmf_matmul_dtype="bfloat16_q_simul"))
    profile_call(f"separate_batch (B={MAIN_BATCH}, turbo)", lambda: sep.separate_batch(mix),
                 sep_stages)
    del sep
    enh = GCCNMFEnhancer(w_enh_np, cfg_enh)
    profile_call(
        f"enhance (B={MAIN_BATCH}, OfflineConfig(mic_separation_m={ENH_MIC_M}, "
        f"num_tdoas={D}, dictionary_size={K}))", lambda: enh.enhance(mix),
        {"stft_gcc_frontend_cuda": FRONTEND_KERNELS,
         "soft_mask_cuda": ("coherence_rows_kernel", "score_argmax_kernel", "mask_kernel"),
         "tf_synthesis_cuda": ("wiener_spectra_kernel", "frames_kernel", "ola_kernel")})
    del enh

    # ---- 8. streaming: RTGCCNMFProcessor, one captured graph per step ----
    # the default GCCNMFConfig (window 1024, hop 512, block 512, 64 TDOAs at
    # 0.1 m, K = 64, history 128) with a dictionary that the NMF kernel
    # learns (float32, 100 iterations) on the first mixture's |X| at that
    # window and hop
    rt_cfg = GCCNMFConfig()
    scfg = StreamConfig.from_app_config(rt_cfg)
    deadline_ms = scfg.block_size / scfg.sample_rate * 1e3
    x_rt = stft_ops.stft(torch.as_tensor(mix[0], device=dev), sqrt_hamming(scfg.window_size),
                         scfg.hop_size).abs()  # (2, T, F)
    t_rt = x_rt.shape[1]
    w0_rt, h0_rt = nmf_init_numpy(scfg.num_freq, rt_cfg.dictionary_size, 2 * t_rt)
    w_rt = kl_nmf_cuda(x_rt.reshape(1, 2 * t_rt, scfg.num_freq),
                       torch.as_tensor(w0_rt, device=dev)[None],
                       torch.as_tensor(h0_rt, device=dev)[None], NMF_ITERS,
                       matmul_dtype="float32")[0][0].cpu().numpy()
    require(bool(np.isfinite(w_rt).all()), "the streaming dictionary is not finite")
    mix_rt = make_mixture(args.seed + 1, STREAM_BATCH)
    # int16-born audio, so that the int16 wire carries the same input
    mix_rt = (np.round(np.clip(mix_rt, -1.0, 1.0 - 2.0**-15) * 32768.0) / 32768.0).astype(
        np.float32)
    rt_kw = dict(target_tdoa_index=scfg.num_tdoas / 2.0,
                 target_epsilon=rt_cfg.target_tdoa_epsilon, target_beta=rt_cfg.target_tdoa_beta,
                 noise_floor=rt_cfg.target_tdoa_noise_floor,
                 localization_enabled=rt_cfg.localization_enabled,
                 localization_window=rt_cfg.localization_window_size)
    stream_cfgs = {
        "default": scfg,
        "num_h_updates=2": dataclasses.replace(scfg, num_h_updates=2),
        "low-latency": dataclasses.replace(scfg, hop_size=128, block_size=128,
                                           analysis_window="asymmetric", synthesis_length=256),
    }

    def timed_calls(fn, calls=STREAM_CALLS):
        """Median wall seconds of ``fn()`` over ``calls`` calls after a
        warm-up (which captures the graph), the last result, and the kernel
        launches of the timed calls."""
        fn()
        times = []
        reset_counts()
        for _ in range(calls):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t1)
        return statistics.median(times), out, counts()

    stream_rows, launches_rt = {}, {}
    for name, c in stream_cfgs.items():
        proc = RTGCCNMFProcessor(w_rt, c)
        params = StreamParams.default(**rt_kw)
        s1, one, launches_rt[name] = timed_calls(lambda: proc.enhance_signal(mix_rt[0], params))
        require(one.shape == (1, 2, SR * SECONDS // c.block_size * c.block_size)
                and np.isfinite(one).all(), f"stream {name}: output shape or values")
        # the graph against the eager step on the card, block by block
        blocks = torch.as_tensor(proc.blocks_from_signal(mix_rt[:1]), device=dev)
        eager, graph, replay_err, replay_scale = proc.init_state(1), proc.init_state(1), 0.0, 0.0
        for i in range(min(blocks.shape[0], REPLAY_BLOCKS)):
            eager, want, _ = proc.eager_step(eager, blocks[i], params)
            graph, got, _ = proc.step(graph, blocks[i], params)
            replay_err = max(replay_err, float((got - want).abs().max()))
            replay_scale = max(replay_scale, float(want.abs().max()))
            require(torch.equal(graph.target_idx, eager.target_idx),
                    f"stream {name}: graph target differs at block {i}")
        require(replay_err <= 1e-6 * replay_scale,
                f"stream {name}: graph against eager {replay_err} > 1e-6 x {replay_scale}")
        # the card against the port's CPU path (the CPU tests' oracle bars)
        cpu = RTGCCNMFProcessor(w_rt, c, device="cpu").enhance_signal(
            mix_rt[0], StreamParams.default(**rt_kw, device="cpu"))
        err = one - cpu
        snr = snr_db(cpu, one)
        tight = float((np.abs(err) < 3e-4 * np.abs(cpu).max()).mean())
        require(snr > 25.0 and tight > 0.93, f"stream {name}: card against CPU {snr} dB, {tight}")
        stream_rows[name] = dict(
            hop=c.hop_size, block=c.block_size, analysis_window=c.analysis_window,
            num_h_updates=c.num_h_updates, blocks=int(blocks.shape[0]),
            algorithmic_latency_ms=c.algorithmic_latency_s * 1e3,
            enhance_signal_b1_s=s1, audio_s_per_s_b1=SECONDS / s1,
            graph_vs_eager=dict(blocks=min(blocks.shape[0], REPLAY_BLOCKS),
                                max_abs_err=replay_err, bar=f"1e-6 x {replay_scale}"),
            card_vs_cpu=dict(snr_db=snr, tight_share=tight, bars="> 25 dB, > 0.93"))
        del proc
    proc1 = RTGCCNMFProcessor(w_rt, scfg)
    params1 = StreamParams.default(**rt_kw)
    procb = RTGCCNMFProcessor(w_rt, scfg)
    sb, many, launches_rt["default, B=64"] = timed_calls(
        lambda: procb.enhance_signal(mix_rt, params1))
    batch_err = 0.0
    for i in range(STREAM_BATCH):  # each batch element against its stream alone
        batch_err = max(batch_err, float(np.abs(
            many[i] - proc1.enhance_signal(mix_rt[i], params1)[0]).max()))
    require(batch_err <= 1e-5, f"stream B={STREAM_BATCH}: element against alone {batch_err}")
    require(all(v == 0 for c in launches_rt.values() for v in c.values()),
            f"the streaming path launched a kernel: {launches_rt}")
    # the --realtime host loop through the stream command, at B = 1
    with tempfile.TemporaryDirectory() as tmp:
        src, dic = os.path.join(tmp, "stream_mix.wav"), os.path.join(tmp, "W.npy")
        wav.write_wav(mix_rt[0], src, SR)
        np.save(dic, w_rt)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            require(cli.main(["stream", "-i", src, "-o", os.path.join(tmp, "rt.wav"),
                              "--dictionary-file", dic, "--realtime"]) == 0, "stream --realtime")
        realtime = json.loads(buf.getvalue().strip().splitlines()[-1])
        rt_out, _ = wav.read_wav(realtime["output"])
        require(np.isfinite(rt_out).all() and rt_out.shape[-1] == realtime["blocks"] * 512,
                "stream --realtime: output")
    emit("stream", device=kind, nvidia_smi=smi,
         config="GCCNMFConfig() (window 1024, hop 512, block 512, 64 TDOAs, K = 64)",
         configs=stream_rows, batch=STREAM_BATCH, enhance_signal_batch_s=sb,
         audio_s_per_s_batch=STREAM_BATCH * SECONDS / sb,
         batch_vs_alone=dict(max_abs_err=batch_err, bar="1e-5"),
         realtime_host_loop=dict(p50_ms=realtime["p50_ms"], p99_ms=realtime["p99_ms"],
                                 deadline_ms=realtime["deadline_ms"],
                                 deadline_misses=realtime["deadline_misses"],
                                 blocks=realtime["blocks"]),
         deadline_ms=deadline_ms, launches=launches_rt)
    profile_call(f"stream enhance_signal (B=1, {SECONDS} s, GCCNMFConfig())",
                 lambda: proc1.enhance_signal(mix_rt[0], params1), STREAM_STAGES)

    # ---- 9. serving: StreamServer, one captured graph per tick -------------
    blocks_rt = proc1.blocks_from_signal(mix_rt)[:SERVE_TICKS]  # (ticks, 64, 2, 512)

    def serve(slots, streams, **kw):
        """SERVE_TICKS ticks of ``streams`` seeded streams on a server of
        ``slots`` slots; per stream its blocks, and the tick stats."""
        server = StreamServer(w_rt, scfg, max_streams=slots, **kw)
        sids = [server.open_stream(StreamSettings(target_tdoa_index=scfg.num_tdoas / 2.0))
                for _ in range(streams)]
        got = {sid: [] for sid in sids}
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(SERVE_TICKS):
            out = server.process({sid: blocks_rt[t, i] for i, sid in enumerate(sids)})
            for sid, blk in out.items():
                got[sid].append(blk)
        for tail in server.flush():
            for sid, blk in tail.items():
                got[sid].append(blk)
        wall = time.perf_counter() - t1
        server.close()
        c = counts()
        require(all(v == 0 for v in c.values()), f"the server launched a kernel: {c}")
        stats = server.tick_stats()
        outs = np.stack([np.concatenate(got[sid], axis=-1) for sid in sids])
        require(outs.shape == (streams, 2, SERVE_TICKS * scfg.block_size)
                and np.isfinite(outs).all(), "serve: output shape or values")
        audio_s = streams * SERVE_TICKS * scfg.block_size / scfg.sample_rate
        return outs, dict(slots=slots, streams=streams, ticks=SERVE_TICKS, wall_s=wall,
                          realtime_factor=audio_s / wall, tick_stats=stats, **kw)

    # each served stream against the same blocks through a batch-1 processor
    alone = np.stack([proc1.scan_blocks(proc1.init_state(1), blocks_rt[:, i:i + 1],
                                        params1)[1].movedim(0, 2).reshape(
                                            2, -1).cpu().numpy()
                      for i in range(SERVE_SLOTS)])
    served_f32, serve_f32 = serve(SERVE_SLOTS, SERVE_SLOTS, pipeline_depth=2, async_fetch=True)
    serve_err = float(np.abs(served_f32 - alone).max())
    require(serve_err <= 1e-5, f"serve: a slot against its stream alone {serve_err} > 1e-5")
    served_i16, serve_i16 = serve(SERVE_SLOTS, SERVE_SLOTS, pipeline_depth=2, async_fetch=True,
                           wire_dtype="int16")
    # the int16 wire quantizes as the WAV writer does: clip, then truncate
    wire_err = float(np.abs(served_i16 - np.clip(served_f32, -1.0, 1.0 - 2.0**-15)).max())
    require(wire_err <= 2.0**-15 + 1e-7, f"serve: int16 wire against float32 {wire_err}")
    served_sync, serve_sync = serve(1, 1)
    sync_err = float(np.abs(served_sync[0] - alone[0]).max())
    require(sync_err <= 1e-5, f"serve: synchronous stream against alone {sync_err}")
    emit("serve", device=kind, nvidia_smi=smi, config="GCCNMFConfig()",
         runs=[serve_f32, serve_i16, serve_sync],
         slot_vs_alone=dict(max_abs_err=serve_err, bar="1e-5"),
         int16_vs_float32=dict(max_abs_err=wire_err, bar="2^-15 + 1e-7 against the clipped "
                                                          "float32 output"),
         sync_vs_alone=dict(max_abs_err=sync_err, bar="1e-5"))
    server = StreamServer(w_rt, scfg, max_streams=SERVE_SLOTS, pipeline_depth=2,
                          async_fetch=True)
    sids = [server.open_stream() for _ in range(SERVE_SLOTS)]

    def ticks20():
        for t in range(20):
            server.process({sid: blocks_rt[t, i] for i, sid in enumerate(sids)})
        server.flush()

    profile_call(f"serve 20 ticks ({SERVE_SLOTS} slots, depth 2, async fetch, float32 wire)",
                 ticks20, STREAM_STAGES)
    server.close()

    # ---- 10. pretraining: the pretrain command on a seeded WAV corpus -----
    corpus_tmp = tempfile.TemporaryDirectory()
    tmp = corpus_tmp.name
    corpus_mix = make_mixture(args.seed + 2, PRETRAIN_WAVS)
    wav_paths = [os.path.join(tmp, f"corpus_{i:02d}.wav") for i in range(PRETRAIN_WAVS)]
    for x, path in zip(corpus_mix, wav_paths):
        wav.write_wav(x, path, SR)
    del corpus_mix
    cache_dir, save_dir = os.path.join(tmp, "cache"), os.path.join(tmp, "W")
    # each size's seconds and launches, read around pretrain_dictionary as
    # the command calls it
    per_size, train = [], pretrain.pretrain_dictionary

    def timed_once(fn):
        """``(*fn(), ms)``: one call of ``fn`` between two CUDA events."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return (*out, start.elapsed_time(end))

    def timed_pretrain(corpus, size, **kw):
        before = kl_nmf_cuda.launches
        t1 = time.perf_counter()
        w = train(corpus, size, **kw)
        per_size.append(dict(size=size, seconds=time.perf_counter() - t1,
                             launches=kl_nmf_cuda.launches - before))
        return w

    pretrain_argv = [*wav_paths, "--sizes", *map(str, PRETRAIN_SIZES), "--cache-dir", cache_dir,
                     "--save-dir", save_dir]
    pretrain_runs = []
    pretrain.pretrain_dictionary = timed_pretrain
    try:
        for run in ("train", "cache hit"):
            per_size.clear()
            buf = io.StringIO()
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.pretrain_main(pretrain_argv)
            seconds = time.perf_counter() - t1
            c = counts()
            info = json.loads(buf.getvalue().strip().splitlines()[-1])
            require(rc == 0 and info["corpus_frames"] == PRETRAIN_FRAMES
                    and info["dictionaries"] == {str(k): [f, k] for k in PRETRAIN_SIZES},
                    f"pretrain ({run}): {info}")
            # JAX's unguarded plain updates: no kernel, trained or cached
            require(sum(c.values()) == 0
                    and [r["launches"] for r in per_size] == [0] * len(PRETRAIN_SIZES),
                    f"pretrain ({run}): launches {c}, per size {per_size}")
            pretrain_runs.append(dict(run=run, seconds=seconds, launches=c,
                                      sizes=list(per_size)))
    finally:
        pretrain.pretrain_dictionary = train
    # the corpus again in-process: the cache files carry its fingerprint
    corpus = pretrain.training_corpus_from_wavs(wav_paths)
    tag = pretrain._corpus_fingerprint(corpus)
    v_c = torch.as_tensor(corpus, device=dev)
    t_c = corpus.shape[0]
    pretrain_checks = {}
    for k in PRETRAIN_SIZES:
        name = f"W_{k}_win{WIN}_it{NMF_ITERS}_s0_{tag}.npy"
        require(os.path.exists(os.path.join(cache_dir, name)), f"pretrain: no cache file {name}")
        w_saved = np.load(os.path.join(save_dir, f"W_{k}.npy"))
        require(np.array_equal(w_saved, np.load(os.path.join(cache_dir, name))),
                f"pretrain: W_{k}.npy is not the cached W")
        w0c, h0c = (torch.as_tensor(x, device=dev) for x in nmf_init_numpy(f, k, t_c))
        got = kl_nmf_cuda(v_c, w0c, h0c, NMF_CHECK_ITERS, matmul_dtype="float32")
        want = kl_nmf(v_c, w0c, h0c, NMF_CHECK_ITERS)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-6 * float(w_.abs().max()))
        # one timed call each (CUDA events), both warm: the command ran
        # the plain updates at this size, and the check above the kernel
        w_p, h_p, unguarded_ms = timed_once(lambda: kl_nmf(v_c, w0c, h0c, NMF_ITERS))
        require(np.array_equal(w_p.cpu().numpy(), w_saved),
                f"pretrain: W_{k} is not one plain kl_nmf call from the seeded init")
        w_k, h_k, kernel_ms = timed_once(
            lambda: kl_nmf_cuda(v_c, w0c, h0c, NMF_ITERS, matmul_dtype="float32"))
        kl_k, kl_p = (float(kl_divergence(v_c, w_.double(), h_.double()))
                      for w_, h_ in ((w_k, h_k), (w_p, h_p)))
        require(abs(kl_k - kl_p) <= 0.005 * kl_p, f"pretrain K={k}: KL {kl_k} vs plain {kl_p}")
        pretrain_checks[k] = dict(
            rtol_1e4_after=NMF_CHECK_ITERS, kl_kernel=kl_k, kl_plain=kl_p,
            kl_rel_diff=abs(kl_k - kl_p) / kl_p,
            max_abs_err_w=max_err(torch, got[0], want[0])[0],
            kernel_ms=kernel_ms, unguarded_plain_ms=unguarded_ms,
            timed=f"one call of {NMF_ITERS} iterations; the plain version is JAX's unguarded "
                  "kl_nmf, which pretraining runs on either device")
        if k == PRETRAIN_SIZES[-1]:  # the kernel row at the corpus shape
            dt_ = torch.float32
            hb_, wb_, q_ = (torch.rand(shape, device=dev, dtype=dt_)
                            for shape in ((t_c, k), (f, k), (t_c, f)))
            products = lambda hb_=hb_, wb_=wb_, q_=q_: (  # noqa: E731
                hb_ @ wb_.T, q_ @ wb_, q_.T @ hb_, hb_ @ wb_.T)
            gemm_library_ms = time_ms(torch, products) * NMF_ITERS
            del hb_, wb_, q_, products
            args_ = (v_c, w0c, h0c)
            record(
                "kl_nmf_cuda", "float32", 1, "gccnmf_torch/csrc/nmf.cu",
                "gccnmf_tpu/ops/nmf_pallas.py:218", got, None, 0.0,
                lambda: kl_nmf_cuda(*args_, NMF_ITERS, matmul_dtype="float32"),
                lambda: kl_nmf_plain(*args_, NMF_ITERS, matmul_dtype="float32"),
                flops=8 * t_c * f * k * NMF_ITERS, shape=f",T{t_c},K{k}",
                counted=f"4 GEMMs of 2·T·F·K per iteration, {NMF_ITERS} iterations",
                nbytes=t_c * f * 4 + 2 * 4 * (f * k + t_c * k),
                check_fn=lambda: kl_nmf_cuda(*args_, NMF_CHECK_ITERS, matmul_dtype="float32"),
                err=pretrain_checks[k]["max_abs_err_w"],
                note=(f"{NMF_CHECK_ITERS} iterations: rtol 1e-4, atol 1e-6 x max|plain|; "
                      f"KL within 0.5 % of the plain version's at {NMF_ITERS}"),
                iterations_timed=NMF_ITERS, design="simt2", gemm_library_ms=gemm_library_ms,
                gemm_library_note=(f"H·Wᵀ twice, Q·W, Qᵀ·H as torch.matmul on float32 "
                                   f"operands at T = {t_c}, times {NMF_ITERS}; not the same "
                                   "function, so library_ms stays null"),
                off_path="pretrain_main runs JAX's unguarded plain updates (0 launches)")
        if k == PRETRAIN_SIZES[0]:  # chunked and resumed, against one plain call
            reset_counts()
            ck = checkpoint.kl_nmf_checkpointed(v_c, w0c, h0c, NMF_ITERS,
                                                os.path.join(tmp, "ck_a"), checkpoint_every=25)
            ck_launches = counts()["kl_nmf_cuda"]
            checkpoint.kl_nmf_checkpointed(v_c, w0c, h0c, NMF_ITERS // 2,
                                           os.path.join(tmp, "ck_b"), checkpoint_every=25)
            resumed = checkpoint.kl_nmf_checkpointed(v_c, w0c, h0c, NMF_ITERS,
                                                     os.path.join(tmp, "ck_b"),
                                                     checkpoint_every=25)
            require(ck_launches == 0, f"kl_nmf_checkpointed: {ck_launches} launches")
            require(all(torch.equal(a, b) for a, b in zip((*ck, *resumed), (w_p, h_p) * 2)),
                    "kl_nmf_checkpointed: chunked or resumed run is not one plain call bit "
                    "for bit")
    # get_dictionaries' larger sizes (a 33.6 MB part buffer at K = 1,024),
    # which the command's --sizes leave out: the kernel against the plain
    # version at the corpus shape
    for k in (k for k in pretrain.DEFAULT_SIZES if k not in PRETRAIN_SIZES):
        w0c, h0c = (torch.as_tensor(x, device=dev) for x in nmf_init_numpy(f, k, t_c))
        got = kl_nmf_cuda(v_c, w0c, h0c, NMF_CHECK_ITERS, matmul_dtype="float32")
        want = kl_nmf(v_c, w0c, h0c, NMF_CHECK_ITERS)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-6 * float(w_.abs().max()))
        require(all(bool(torch.isfinite(g).all()) for g in got), f"pretrain K={k}: not finite")
        pretrain_checks[k] = dict(rtol_1e4_after=NMF_CHECK_ITERS,
                                  max_abs_err_w=max_err(torch, got[0], want[0])[0])
        del got, want
    del v_c
    emit("pretrain", device=kind, nvidia_smi=smi,
         argv=f"{PRETRAIN_WAVS} WAVs --sizes 64 128 256 (window {WIN}, hop 512, "
              f"{NMF_ITERS} iterations)", corpus_frames=t_c, runs=pretrain_runs,
         checks=pretrain_checks,
         checkpointed=dict(iterations=NMF_ITERS, every=25, launches=ck_launches,
                           resumed_from=NMF_ITERS // 2, bit_equal_to_one_call=True))

    # ---- 11. online: OnlineGCCNMFEnhancer with the pretrained W_64 -------
    w64_path = os.path.join(save_dir, "W_64.npy")
    w64 = np.load(w64_path)
    audio = np.stack([wav.read_wav(p)[0] for p in wav_paths[:MAIN_BATCH]])
    online_cfgs = {"sliding": OnlineConfig(), "exponential": OnlineConfig(smoothing="exponential"),
                   "cumulative": OnlineConfig(smoothing="cumulative"),
                   "num_h_updates=2": OnlineConfig(num_h_updates=2)}
    online_rows = {}
    for name, oc in online_cfgs.items():
        enh = OnlineGCCNMFEnhancer(w64, oc)
        paths = [("b1", lambda enh=enh: enh.enhance(audio[0]))]
        if name == "sliding":
            paths.append(("b16", lambda enh=enh: enh.enhance(audio)))
        run = run_paths(paths)
        require(all(v == 0 for c in run["counts"].values() for v in c.values()),
                f"online {name}: a kernel launched: {run['counts']}")
        one = run["b1"]
        n_on = one["enhanced"].shape[-1]
        require(one["enhanced"].shape == (2, n_on) and np.isfinite(one["enhanced"]).all(),
                f"online {name}: output")
        cpu = OnlineGCCNMFEnhancer(w64, oc, device="cpu").enhance(audio[0])
        snrs = [snr_db(r, e) for r, e in zip(cpu["enhanced"], one["enhanced"])]
        agree = float((cpu["target_tdoa_index"] == one["target_tdoa_index"]).mean())
        require(min(snrs) > 25.0 and agree >= 0.99,
                f"online {name}: card against CPU {snrs} dB, targets {agree}")
        row = dict(b1_s=run["s_b1"], audio_s_per_s_b1=SECONDS / run["s_b1"],
                   seconds_per_call=run["seconds"], card_vs_cpu=dict(
                       snr_db=snrs, target_agreement=agree, bars="> 25 dB, >= 0.99"))
        if name == "sliding":
            many = run["b16"]
            err, scale = 0.0, 0.0
            for i in range(MAIN_BATCH):
                alone = one if i == 0 else enh.enhance(audio[i])
                require(np.array_equal(many["target_tdoa_index"][i], alone["target_tdoa_index"]),
                        f"online batch[{i}]: targets differ from alone")
                err = max(err, float(np.abs(many["enhanced"][i] - alone["enhanced"]).max()))
                scale = max(scale, float(np.abs(alone["enhanced"]).max()))
            require(err <= BATCH_TOL * scale, f"online batch against alone: {err} > "
                                              f"{BATCH_TOL} x {scale}")
            row.update(batch=MAIN_BATCH, b16_s=run["s_b16"],
                       audio_s_per_s_b16=MAIN_BATCH * SECONDS / run["s_b16"],
                       batch_vs_alone=dict(max_abs_err=err, bar=f"{BATCH_TOL} x {scale}"))
            enh_online = enh
        online_rows[name] = row
    emit("online", device=kind, nvidia_smi=smi,
         config="OnlineConfig() (sliding 6, window 1024, hop 512, 64 TDOAs at 0.1 m), W_64",
         configs=online_rows, launches="0 of every wrapper")
    profile_call(f"online enhance (B={MAIN_BATCH}, {SECONDS} s, OnlineConfig())",
                 lambda: enh_online.enhance(audio), STREAM_STAGES)
    del enh_online

    # ---- 12. enhance_cli: the enhance command over 16 WAVs ----------------
    cli_dirs = {d: os.path.join(tmp, d) for d in ("card", "cpu")}
    cli_paths = {}
    for d, base in cli_dirs.items():
        os.makedirs(base)
        cli_paths[d] = [shutil.copy(p, base) for p in wav_paths[:MAIN_BATCH]]
    gcfg = GCCNMFConfig()
    in_process = {
        "online": OnlineGCCNMFEnhancer(w64, OnlineConfig(
            sample_rate=SR, window_size=gcfg.window_size, hop_size=gcfg.hop_size,
            num_tdoas=gcfg.num_tdoas, mic_separation_m=gcfg.microphone_separation_in_metres,
            smoothing_window=gcfg.localization_window_size)),
        "offline": GCCNMFEnhancer(w64, OfflineConfig(
            window_size=gcfg.window_size, hop_size=gcfg.hop_size, num_tdoas=gcfg.num_tdoas,
            mic_separation_m=gcfg.microphone_separation_in_metres, sample_rate=SR))}

    def enhance_command(mode, device):
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["enhance", *cli_paths[device], "--mode", mode, "--dictionary-file",
                           w64_path, "--device", "cuda" if device == "card" else "cpu"])
        seconds = time.perf_counter() - t1
        outs = json.loads(buf.getvalue().strip().splitlines()[-1])["outputs"]
        require(rc == 0 and len(outs) == MAIN_BATCH, f"enhance {mode} on {device}: {outs}")
        return [wav.read_wav(p)[0] for p in outs], seconds, counts()

    cli_rows = {}
    for mode in ("online", "offline"):
        outs, seconds, c = enhance_command(mode, "card")
        want_k = enh_kernels if mode == "offline" else ()
        require(all(c[k] == MAIN_BATCH for k in want_k)
                and sum(c.values()) == MAIN_BATCH * len(want_k),
                f"enhance --mode {mode}: launches {c}")
        for i, out in enumerate(outs):  # the in-process enhancer, as the WAV writer stores it
            ref_path = os.path.join(tmp, "in_process.wav")
            wav.write_wav(in_process[mode].enhance(audio[i])["enhanced"], ref_path, SR)
            require(np.array_equal(out, wav.read_wav(ref_path)[0]),
                    f"enhance --mode {mode}: file {i} differs from the in-process enhancer")
        cli_rows[mode] = dict(files=MAIN_BATCH, seconds=seconds,
                              audio_s_per_s=MAIN_BATCH * SECONDS / seconds, launches=c,
                              equals_in_process=True)
        if mode == "offline":
            cpu_outs, cpu_s, cpu_c = enhance_command(mode, "cpu")
            require(sum(cpu_c.values()) == 0, f"enhance on the CPU launched {cpu_c}")
            snrs = [snr_db(r, e) for ro, eo in zip(cpu_outs, outs) for r, e in zip(ro, eo)]
            require(min(snrs) > CLI_SNR_DB,
                    f"enhance --mode offline: card against CPU {min(snrs)} dB")
            cli_rows[mode]["card_vs_cpu"] = dict(min_snr_db=min(snrs), bar=f"> {CLI_SNR_DB} dB",
                                                 cpu_seconds=cpu_s)
            # each kernel the command ran, at its shapes (window 1024, hop
            # 512, 64 TDOAs, W_64, one file a call), against its plain
            # version on the first file, with the enhancer's own operands
            off, first = in_process["offline"], len(rows)
            ocfg = off.config
            check_enhance_kernels(
                1, (offline_mod.gemm_dtype(ocfg),), x=torch.as_tensor(audio[:1], device=dev),
                hop=ocfg.hop_size, fe=(off._dft_basis, off._cos, off._sin), w=off.w,
                tb=off._tf_basis, mask=(off.target_epsilon, off.target_beta, off.noise_floor),
                shape=f",hop{ocfg.hop_size},D{ocfg.num_tdoas},K{off.w.shape[-1]}")
            for row in rows[first:]:
                row["launches"] = c[row["kernel"]]
                row["launches_on"] = (f"enhance --mode offline over {MAIN_BATCH} files "
                                      "(one launch a file)")
    del in_process
    # stream without --dictionary-file: W from the pretraining cache
    stream_cache = os.path.join(tmp, "stream_cache")
    os.environ["GCCNMF_TPU_CACHE_DIR"] = stream_cache
    try:
        stream_launches, stream_cached = [], []
        for _ in range(2):
            buf = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["stream", "-i", cli_paths["card"][0], "-o",
                               os.path.join(tmp, "stream.wav")])
            stream_launches.append(sum(counts().values()))
            stream_cached.append({name: os.stat(os.path.join(stream_cache, name)).st_mtime_ns
                                  for name in os.listdir(stream_cache)})
            out, _ = wav.read_wav(json.loads(buf.getvalue().strip().splitlines()[-1])["output"])
            require(rc == 0 and np.isfinite(out).all() and np.abs(out).max() > 0,
                    "stream without --dictionary-file: output")
    finally:
        del os.environ["GCCNMF_TPU_CACHE_DIR"]
    cached = sorted(stream_cached[0])
    # trained once (JAX's plain updates, no launch), then found unchanged
    require(stream_launches == [0, 0] and len(cached) == 1
            and stream_cached[1] == stream_cached[0]
            and cached[0].startswith(f"W_{gcfg.dictionary_size}_win{WIN}_it{NMF_ITERS}_s0_"),
            f"stream without --dictionary-file: launches {stream_launches}, cache "
            f"{stream_cached}")
    emit("enhance_cli", device=kind, nvidia_smi=smi,
         argv=f"enhance <{MAIN_BATCH} WAVs> --mode online|offline --dictionary-file W_64.npy",
         modes=cli_rows, stream_without_dictionary=dict(launches=stream_launches,
                                                        cache_file=cached[0],
                                                        second_run="cache hit, file unchanged"))
    corpus_tmp.cleanup()

    # ---- 13. long_audio: LongAudioSeparator, one hour streamed from disk ----
    long_audio_phase(torch, args.seed, kind, smi, record, reset_counts, counts)
    nmf_row_cap_phase(torch, kind, smi)

    # ---- 14. distributed: the process groups in a world of one over NCCL ----
    distributed_phase(torch, args.seed, kind, smi, reset_counts, counts)

    # ---- 15. realtime: the realtime app, its command and the native tier ----
    realtime_phase(torch, kind, smi, reset_counts, counts, w_rt, mix_rt[0])

    # ---- 16. serve_mesh: StreamServer(mesh=local_mesh(...)) ----------------
    serve_mesh_phase(torch, kind, smi, reset_counts, counts, w_rt, scfg, blocks_rt)

    # ---- 17. conv_stft: the conv STFT against fft --------------------------
    conv_stft_phase(torch, kind, smi, reset_counts, counts, mix[0])

    # ---- 18. metrics: the scores of separate's outputs ---------------------
    metrics_phase(kind, smi, args.seed, single)

    # ---- 19. stamp: the run stamp without a CUDA context --------------------
    stamp_phase(torch, kind, smi)

    # launches of each kernel on the main path that runs it at its mode and
    # batch: separate_batch / enhance of the batch for the B = 16 rows,
    # separate / enhance of one mixture for the B = 2 rows; bf16 front-end
    # and synthesis GEMMs belong to the default config
    runs = {"float32": f32, "bfloat16": bf16, "bfloat16_q": main, "bfloat16_q_simul": turbo}
    for row in rows:
        name, mode = row["kernel"], row["mode"]
        if "launches_on" in row:  # set by its own phase (enhance_cli)
            require(row["launches"] > 0, f"{row['name']} never launched on the main path")
            continue
        if "off_path" in row:  # a shape of a mode whose main path is another
            row["launches"] = f32["counts"]["separate"][name]
            row["launches_on"] = ("separate, nmf_matmul_dtype='float32', the main path of "
                                  f"this mode; at this shape {row.pop('off_path')}")
            require(row["launches"] > 0, f"{row['name']} never launched on the main path")
            continue
        if name in ("soft_mask_cuda", "tf_synthesis_cuda"):
            run = enh32[0] if mode == "float32" else enh_main
            path = "enhance_batch" if row["batch"] == MAIN_BATCH else "enhance"
        else:
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
