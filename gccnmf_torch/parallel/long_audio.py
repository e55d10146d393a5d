"""Long-audio separation, on one device or time-sharded over a process group
(counterpart of ``gccnmf_tpu/parallel/long_audio.py``).

``GCCNMFSeparator`` holds a whole utterance, its planes and every target's
reconstruction at once: right for 10 s clips, not for an hour-long meeting
or lecture. :meth:`LongAudioSeparator.separate_streamed` streams a WAV of
any length instead:

1. Pass 1 reads the file in macro-chunks of ``chunk_frames`` STFT frames
   (int16 files as raw PCM, converted on the device by /32768) and runs the
   STFT, the guarded GCC-PHAT coherence and the angular spectrogram chunk by
   chunk into planes preallocated on the device: the spectrum planes at the
   pipeline's plane dtype (bf16 in the throughput modes), V in fp32. The
   angular sum accumulates on the device; the loop waits only for the copy
   of a staging buffer it is about to reuse.
2. One KL-NMF over the whole (2T, F) V in exact fp32 with the silence
   guards, or the turbo updates (``nmf.kl_nmf_simul``) when
   ``nmf_matmul_dtype == "bfloat16_q_simul"``. On one device the exact
   fp32 NMF is kernel 1's float32 mode (``nmf_cuda.kl_nmf_cuda``, the
   guarded ``nmf.kl_nmf`` itself on the CPU): on an H100 it runs one audio
   hour's 100 iterations in about 1.6 s against the plain updates' 2.85 s.
3. Localization on the host in float64.
4. Pass 2 reconstructs chunk by chunk: the coherence again from the planes
   as stored, hard coefficient masks, then per target the masked spectrum,
   its inverse frames and their overlap-add, with the f32 seam carried to
   the next chunk. Gain, the clip tally and the int16 conversion run on the
   device; up to :data:`LOOKAHEAD` chunks are in flight into pinned host
   buffers, and the WAVs are written as they arrive.

Host RAM stays O(chunk); device memory holds the planes, V and the NMF
state, O(file). JAX runs every stage of this path as XLA ops and reaches no
Pallas kernel (an hour's V cannot be VMEM-resident), so the port runs them
as torch ops on either device, except the one-device exact NMF: that is
JAX's guarded ``kl_nmf``, which the port's kernel 1 computes in its
float32 mode (one launch a file), since it beats the plain updates there.

:meth:`LongAudioSeparator.separate` is the in-memory path on one shard:
the same math over a (2, n) array held whole, with the attribution winner
of ``masks.attribution_winner_planes`` and one target at a time.

With a ``mesh`` (``parallel.mesh.make_mesh``, data axis only) every rank
of the world builds the separator and calls it with the same arguments;
the time axis is split into one shard of frames per data rank, as JAX's
``shard_map`` pipeline does. Each rank computes its shard's STFT, coherence
and V; the angular sums are all-reduced over ``data``; the NMF is
``parallel.nmf_sharded.kl_nmf_sharded`` with the silence guards (or the
turbo updates); H0 is the reference draw's rows of this shard, left frames
then right, the order of its V rows. Each target's overlap-added frames
pass their ``window − hop`` trailing samples to the next data rank
(``batch_isend_irecv``, JAX's ``ppermute``). ``separate`` all-gathers the
settled blocks; ``separate_streamed`` has each rank read only its own
sample range from the WAV, and rank 0 writes the files, receiving one shard
at a time in data order, so host RAM stays O(shard) on every rank.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.device import resolve_device
from gccnmf_torch.models.offline import OfflineConfig, plane_dtype, stft_gain
from gccnmf_torch.ops import gcc, localize, masks, nmf
from gccnmf_torch.ops import stft as stft_ops
from gccnmf_torch.ops.nmf_cuda import kl_nmf_cuda
from gccnmf_torch.ops.windows import hann_symmetric
from gccnmf_torch.parallel import mesh as mesh_lib
from gccnmf_torch.parallel.nmf_sharded import kl_nmf_sharded
from gccnmf_torch.precision import set_fp32_precision
from gccnmf_torch.serving import float_to_pcm, pcm_to_float
from gccnmf_torch.utils import wav
from gccnmf_torch.utils.hostmem import PeriodicTrim

__all__ = ["LongAudioSeparator", "LOOKAHEAD", "UPLOAD_SLOTS"]

# chunks of int16 output in flight from the device (JAX's lookahead): about
# 100 MB of PCM at the default chunk width and three targets
LOOKAHEAD = 8
# pinned staging buffers of input samples: one is filled while the card
# reads the other
UPLOAD_SLOTS = 2


class _PinnedRing:
    """``depth`` slots of pinned host buffers (one of each shape and dtype)
    for copies between host and card, each kind one allocation. A slot is
    handed out again only once the copy that last used it has finished (its
    CUDA event), so a lookahead never overwrites a buffer a copy still
    reads or fills."""

    def __init__(self, depth: int, shapes, dtypes, device: torch.device):
        self.blocks = [torch.empty((depth, *s), dtype=d, pin_memory=True)
                       for s, d in zip(shapes, dtypes)]
        self.events: list = [None] * depth
        self.next = 0
        self.device = device

    def take(self) -> tuple[int, list]:
        slot = self.next
        self.next = (slot + 1) % len(self.events)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        return slot, [block[slot] for block in self.blocks]

    def mark(self, slot: int) -> torch.cuda.Event:
        """Record the end of the copies just queued on slot ``slot``."""
        self.events[slot] = torch.cuda.current_stream(self.device).record_event()
        return self.events[slot]


class LongAudioSeparator:
    """GCC-NMF separation of recordings of any length, on one device or over
    a mesh.

    ``device=None`` means the card (raises without one); pass
    ``device="cpu"`` for the CPU. ``chunk_frames`` is the macro-chunk width
    of :meth:`separate_streamed` in STFT frames. ``nmf_init="reference"``
    draws the reference's MT19937 ``seed(0)`` init on the host in atom
    blocks; ``"device"`` draws H0 on the device from a generator seeded
    with 0 (W0 stays host-seeded): no H0 upload, deterministic, but another
    trajectory, so never the parity path.

    ``mesh``: a data-only ``DeviceMesh`` (``parallel.mesh``) shards the time
    axis over its data ranks (module docstring); each rank's device is the
    mesh's, and with ``nmf_init="device"`` each rank draws its own H0 rows
    from a generator seeded with its data rank."""

    def __init__(self, config: OfflineConfig = OfflineConfig(), device=None,
                 chunk_frames: int = 8192, nmf_init: str = "reference", mesh=None):
        if nmf_init not in ("reference", "device"):
            raise ValueError(f"unknown nmf_init {nmf_init!r}")
        if config.nmf_matmul_dtype not in nmf.MATMUL_DTYPES:
            raise ValueError(f"unknown nmf_matmul_dtype {config.nmf_matmul_dtype!r}")
        self.config = config
        self.mesh = mesh
        self.num_shards, self._shard = 1, 0
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if mesh_lib.axis_size(mesh, "model") != 1:
                raise ValueError("LongAudioSeparator uses a data-only mesh")
            if device is not None and resolve_device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
            self.device = mesh_lib.mesh_device(mesh)
            self.num_shards = mesh_lib.axis_size(mesh, "data")
            self._shard = mesh.get_local_rank("data")
            self._data_group = mesh.get_group("data")
            # the seam exchange and the writer address global ranks
            self._peers = mesh.mesh[:, 0].tolist()
        set_fp32_precision()
        self.chunk_frames = int(chunk_frames)
        self.nmf_init = nmf_init
        self._stft_method = config.resolved_stft_method()
        self._inv_method = "matmul" if self._stft_method == "matmul" else "fft"
        cos_m, sin_m = gcc.steering_cos_sin(
            float(config.sample_rate), config.num_freq, config.mic_separation_m,
            config.num_tdoas,
        )
        state = from_numpy_state({"window": hann_symmetric(config.window_size), "cos": cos_m,
                                  "sin": sin_m}, self.device)
        self._window, self._cos, self._sin = state["window"], state["cos"], state["sin"]

    def _for_rate(self, sample_rate: int) -> "LongAudioSeparator":
        return LongAudioSeparator(replace(self.config, sample_rate=sample_rate), self.device,
                                  chunk_frames=self.chunk_frames, nmf_init=self.nmf_init,
                                  mesh=self.mesh)

    # ---- shared stages ------------------------------------------------------

    def _frame_geometry(self, n_samples: int) -> tuple[int, int, int]:
        """(frames a shard, frames processed, samples a shard covers): the
        trailing frames that do not fill every shard are dropped, and the
        shards' sample ranges overlap by ``window − hop``."""
        cfg = self.config
        s = self.num_shards
        window, hop = cfg.window_size, cfg.hop_size
        t_s = stft_ops.num_frames(n_samples, window, hop) // s
        # t_s < 1 must fail too: with hop == window the seam test alone would
        # pass zero frames
        if t_s < 1 or t_s * hop < window - hop:
            raise ValueError(f"audio too short to shard {s} ways: {t_s} frames/shard")
        return t_s, t_s * s, (t_s - 1) * hop + window

    def _h0_rows(self, t_s: int, t: int):
        """The rows of the reference's (2T, K) H0 (left frames, then right)
        that this shard's V rows meet, in their order: its left frames,
        then its right ones. None for one shard, which holds them all."""
        if self.num_shards == 1:
            return None
        left = np.arange(self._shard * t_s, (self._shard + 1) * t_s)
        return np.concatenate([left, t + left])

    def _h0_device_chunked(self, t2: int, atom_block: int = 8, rows=None):
        """``(W0 (F, K) NumPy, H0 (t2, K) on the device)`` with host RAM of
        O(t2·atom_block); with ``rows``, only those rows of H0.

        ``nmf_init_numpy`` draws H as one (K, t2) float64 array, gigabytes
        for an hour. Its MT19937 stream is K-major, so drawing atom blocks
        in turn reproduces it bit for bit: each block is cast, offset by ε
        and copied into a (K, rows) buffer on the device, transposed once
        there. With ``nmf_init="device"`` H0 is drawn on the device
        instead, from a generator seeded with the data rank."""
        cfg = self.config
        k = cfg.dictionary_size
        n_rows = t2 if rows is None else len(rows)
        rs = np.random.RandomState(0)  # seed(0)'s stream, the caller's RNG untouched
        w0 = rs.random_sample((cfg.num_freq, k)).astype(np.float32) + cfg.epsilon
        if self.nmf_init == "device":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._shard)
            h0 = torch.rand((n_rows, k), generator=gen, device=self.device) + cfg.epsilon
            return w0, h0
        buf = torch.empty((k, n_rows), dtype=torch.float32, device=self.device)
        for k0 in range(0, k, atom_block):
            kb = min(atom_block, k - k0)
            blk = rs.random_sample((kb, t2)).astype(np.float32)
            blk += cfg.epsilon  # in place: the float32 add of nmf_init_numpy
            buf[k0 : k0 + kb] = torch.from_numpy(blk if rows is None else blk[:, rows])
        return w0, buf.T.contiguous()

    def _run_nmf(self, v2: torch.Tensor, w0: np.ndarray, h0: torch.Tensor):
        """KL-NMF of V (2T, F), or of this shard's rows over the mesh: exact
        fp32 with the silence guards, or the turbo updates (always
        guarded). On one device the exact one is kernel 1's float32 mode
        (the guarded plain ``kl_nmf`` on the CPU); the mesh and the turbo
        updates stay on the plain updates, as in JAX."""
        cfg = self.config
        w0 = torch.as_tensor(w0, device=self.device)
        args = (cfg.num_iterations, cfg.sparsity_alpha, cfg.epsilon)
        turbo = cfg.nmf_matmul_dtype == "bfloat16_q_simul"
        if self.mesh is not None:
            return kl_nmf_sharded(v2, w0, h0, cfg.num_iterations, self.mesh, cfg.sparsity_alpha,
                                  cfg.epsilon, simultaneous=turbo, guard=True)
        if turbo:
            return nmf.kl_nmf_simul(v2, w0, h0, *args)
        return kl_nmf_cuda(v2, w0, h0, *args, matmul_dtype="float32")

    def _synthesize(self, coef_n, spec, w, h_stereo) -> torch.Tensor:
        """One target's masked spectrum → its overlap-added frames (2, L):
        the ISTFT without the trim or the gain."""
        cfg = self.config
        spec_est = masks.masked_reconstruction(coef_n[None], spec, w, h_stereo)[0]
        frames = stft_ops.inverse_frames(spec_est.conj().resolve_conj(), cfg.window_size,
                                         self._inv_method)
        return stft_ops.overlap_add(frames * self._window, cfg.hop_size)

    def _separate_core(self, x: torch.Tensor, t_s: int, num_sources):
        """This shard's samples (2, (t_s − 1)·hop + window) on the device →
        ``(y, targets, W, mean angular spectrum)``: ``y`` (N, 2, t_s·hop +
        window − hop) is each target's overlap-added frames, its seams not
        yet exchanged."""
        cfg = self.config
        t = t_s * self.num_shards
        spec = stft_ops.stft(x, self._window, cfg.hop_size, conjugate=True,
                             method=self._stft_method)  # (2, t_s, F)
        coh = gcc.coherence(spec, guard_zeros=True)
        ang_sum = gcc.angular_spectrogram(coh, self._cos, self._sin).sum(dim=0)
        if self.num_shards > 1:
            dist.all_reduce(ang_sum, group=self._data_group)
        v2 = torch.cat([spec[0].abs(), spec[1].abs()])  # (2 t_s, F), left‖right
        w0, h0 = self._h0_device_chunked(2 * t, rows=self._h0_rows(t_s, t))
        w, h = self._run_nmf(v2, w0, h0)
        del v2, h0

        mean_ang = ang_sum.cpu().numpy() / t
        targets = localize.estimate_target_tdoa_indexes(mean_ang, num_sources)
        targets_t = torch.tensor([targets], dtype=torch.long, device=self.device)
        winner = masks.attribution_winner_planes(coh.real[None], coh.imag[None], self._cos,
                                                 self._sin, targets_t, w[None])[0]  # (t_s, K)
        h_stereo = torch.stack([h[:t_s], h[t_s:]])
        # one target at a time: the (N, 2, T, F) estimate never exists
        y = torch.stack([self._synthesize((winner == n).to(torch.float32), spec, w, h_stereo)
                         for n in range(len(targets))])
        return y, targets, w, mean_ang

    def _exchange_seams(self, y: torch.Tensor, t_s: int):
        """``y`` of :meth:`_separate_core` → ``(owned, tail)``: the shard's
        settled t_s·hop samples, its predecessor's ``window − hop`` trailing
        samples added in, and its own trailing samples (the next shard's;
        the last shard's end the output)."""
        cfg = self.config
        own_len, overlap = t_s * cfg.hop_size, cfg.window_size - cfg.hop_size
        own, tail = y[..., :own_len], y[..., own_len:].contiguous()
        i = self._shard
        ops, recv = [], None
        if i + 1 < self.num_shards:
            ops.append(dist.P2POp(dist.isend, tail, self._peers[i + 1], self._data_group))
        if i > 0:
            recv = torch.empty_like(tail)
            ops.append(dist.P2POp(dist.irecv, recv, self._peers[i - 1], self._data_group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            own[..., :overlap] += recv
        return own, tail

    # ---- in memory ----------------------------------------------------------

    @torch.inference_mode()
    def separate(self, stereo: np.ndarray, num_sources: int | None = None):
        """Separate ``(2, n)`` audio of any length held in memory → dict of
        ``estimates`` (N, 2, n_out) float32, ``target_tdoa_indexes``, ``w``,
        ``mean_angular_spectrum`` and ``frames_processed``. ``num_sources``
        None defers to the config, whose None counts the sources. Over a
        mesh every rank passes the whole ``stereo`` and gets the whole
        result; the trailing frames that do not fill every shard (fewer
        than one per shard) are dropped."""
        cfg = self.config
        num_sources = cfg.num_sources if num_sources is None else num_sources
        hop, half = cfg.hop_size, cfg.window_size // 2
        t_s, t, chunk_len = self._frame_geometry(stereo.shape[-1])
        start = self._shard * t_s * hop
        x = torch.as_tensor(np.asarray(stereo[:, start : start + chunk_len], np.float32),
                            device=self.device)
        y, targets, w, mean_ang = self._separate_core(x, t_s, num_sources)
        if self.mesh is not None:  # the whole output, joined on the device
            own, tail = self._exchange_seams(y, t_s)
            y = torch.cat([mesh_lib.gather(own, self.mesh, -1),
                           mesh_lib.gather(tail[None], self.mesh)[-1]], dim=-1)
        return dict(
            estimates=(y[..., half:-half] * stft_gain(cfg)).cpu().numpy(),
            target_tdoa_indexes=targets,
            w=w.cpu().numpy(),
            mean_angular_spectrum=mean_ang,
            frames_processed=t,
        )

    def separate_file(self, mixture_path: str, output_prefix: str | None = None,
                      audio: tuple[np.ndarray, int] | None = None):
        """:meth:`separate` of a WAV → ``<prefix>_sim_<n>.wav`` files
        (``paths`` in the result). Pass ``audio`` as ``(stereo,
        sample_rate)`` to skip re-reading an already-loaded file. Over a
        mesh, data rank 0 writes the files before any rank returns."""
        stereo, sr = audio if audio is not None else wav.read_wav(mixture_path)
        sep = self if sr == self.config.sample_rate else self._for_rate(sr)
        result = sep.separate(stereo)
        prefix = output_prefix or wav.default_output_prefix(mixture_path)
        paths = [f"{prefix}_sim_{i + 1}.wav" for i in range(len(result["estimates"]))]
        if self._shard == 0:
            for est, path in zip(result["estimates"], paths):
                wav.write_wav(est, path, sr)
        if self.mesh is not None:
            dist.barrier(group=self._data_group)
        result["paths"] = paths
        return result

    # ---- streamed from disk -------------------------------------------------

    @torch.inference_mode()
    def separate_streamed(self, mixture_path: str, output_prefix: str | None = None,
                          num_sources: int | None = None):
        """Disk-streamed separation with O(chunk) host RAM: the WAV is read
        by range from a memory map and each ``<prefix>_sim_<n>.wav`` is
        written as its chunks arrive (16-bit PCM, clipped per sample).
        Returns ``paths``, ``target_tdoa_indexes``, ``w``,
        ``mean_angular_spectrum``, ``frames_processed``,
        ``samples_written``, ``host_heap_trims``, ``stage_seconds`` and
        ``transfer_mb``.

        Over a mesh of more than one data rank (module docstring) it returns
        ``paths``, ``target_tdoa_indexes``, ``w``, ``mean_angular_spectrum``,
        ``frames_processed`` and ``samples_written`` on every rank; one data
        rank takes the chunked path above, as in JAX."""
        num_sources = self.config.num_sources if num_sources is None else num_sources
        reader = wav.WavReader(mixture_path)
        if reader.sample_rate != self.config.sample_rate:
            return self._for_rate(reader.sample_rate).separate_streamed(
                mixture_path, output_prefix, num_sources)
        if reader.num_channels != 2:
            raise ValueError(f"expected stereo input, got {reader.num_channels} channels")
        if self.num_shards > 1:
            return self._separate_streamed_sharded(reader, mixture_path, output_prefix,
                                                   num_sources)
        return self._separate_streamed_chunked(reader, mixture_path, output_prefix,
                                               num_sources)

    def _separate_streamed_sharded(self, reader, mixture_path, output_prefix, num_sources):
        """Each rank reads its own sample range; data rank 0 writes the WAVs
        from its block and each other rank's, received one at a time in
        data order (the last rank's trailing seam ends them)."""
        cfg = self.config
        s, i = self.num_shards, self._shard
        t_s, t, chunk_len = self._frame_geometry(reader.num_samples)
        x = torch.as_tensor(reader.read(i * t_s * cfg.hop_size, chunk_len), device=self.device)
        y, targets, w, mean_ang = self._separate_core(x, t_s, num_sources)
        own, tail = self._exchange_seams(y, t_s)
        del y
        prefix = output_prefix or wav.default_output_prefix(mixture_path)
        paths = [f"{prefix}_sim_{n + 1}.wav" for n in range(len(targets))]
        root, group = self._peers[0], self._data_group
        samples_written = None
        if i == 0:
            samples_written = self._write_shards(own, tail, paths, reader.sample_rate)
        else:
            dist.send(own.contiguous(), root, group=group)
            if i == s - 1:
                dist.send(tail, root, group=group)
        # the count, and the files' completion, to every rank
        box = [samples_written]
        dist.broadcast_object_list(box, src=root, group=group)
        return dict(
            paths=paths,
            target_tdoa_indexes=targets,
            w=w.cpu().numpy(),
            mean_angular_spectrum=mean_ang,
            frames_processed=t,
            samples_written=box[0],
        )

    def _write_shards(self, own: torch.Tensor, tail: torch.Tensor, paths, sample_rate) -> int:
        """Data rank 0's writer: its own block, each other shard's received in
        turn into one buffer, then the last shard's seam; the leading and
        trailing half windows trimmed, as JAX. Returns the samples each file
        holds."""
        gain = stft_gain(self.config)
        half = self.config.window_size // 2
        writers = [wav.StreamingWavWriter(p, sample_rate) for p in paths]
        # held-back FIFO per target: which samples the trailing trim removes
        # is known only at the end
        pending = [np.zeros((2, 0), np.float32) for _ in paths]

        def emit(block: np.ndarray) -> None:  # block: (N, 2, L)
            for n, writer in enumerate(writers):
                buf = np.concatenate([pending[n], block[n] * gain], axis=-1)
                if buf.shape[-1] > half:
                    writer.write(buf[:, : buf.shape[-1] - half])
                    buf = buf[:, buf.shape[-1] - half :]
                pending[n] = buf

        emit(own[..., half:].cpu().numpy())
        block = torch.empty_like(own, memory_format=torch.contiguous_format)
        for peer in self._peers[1:]:
            dist.recv(block, peer, group=self._data_group)
            emit(block.cpu().numpy())
        dist.recv(tail, self._peers[-1], group=self._data_group)
        emit(tail.cpu().numpy())
        for writer in writers:
            writer.close()
        return writers[0].samples_written if writers else 0

    def _separate_streamed_chunked(self, reader, mixture_path, output_prefix, num_sources):
        """The macro-chunk loop of one device (module docstring)."""
        cfg = self.config
        dev = self.device
        cuda = dev.type == "cuda"
        win_len, hop = cfg.window_size, cfg.hop_size
        overlap = win_len - hop
        f = cfg.num_freq
        plane = torch.float32 if plane_dtype(cfg) == "float32" else torch.bfloat16

        t_total = stft_ops.num_frames(reader.num_samples, win_len, hop)
        if t_total < 1:
            raise ValueError("audio shorter than one analysis window")
        tc_main = min(self.chunk_frames, t_total)
        chunk_grid = [(t0, min(tc_main, t_total - t0)) for t0 in range(0, t_total, tc_main)]

        # ---- pass 1: chunked analysis into planes on the device
        use_pcm_in = reader.raw_dtype == np.int16
        read = reader.read_raw if use_pcm_in else reader.read
        in_dtype = torch.int16 if use_pcm_in else torch.float32
        n_main = (tc_main - 1) * hop + win_len
        uploads = _PinnedRing(UPLOAD_SLOTS, [(2, n_main)], [in_dtype], dev) if cuda else None

        def upload(samples: np.ndarray) -> torch.Tensor:
            if not cuda:
                return torch.from_numpy(samples)
            slot, (host,) = uploads.take()
            host = host[:, : samples.shape[-1]]
            np.copyto(host.numpy(), samples)
            x = host.to(dev, non_blocking=True)
            uploads.mark(slot)
            return x

        spec_re = torch.zeros((2, t_total, f), dtype=plane, device=dev)
        spec_im = torch.zeros((2, t_total, f), dtype=plane, device=dev)
        v_buf = torch.zeros((2, t_total, f), dtype=torch.float32, device=dev)
        ang_acc = torch.zeros(cfg.num_tdoas, dtype=torch.float32, device=dev)
        trimmer = PeriodicTrim()
        t_start = time.perf_counter()
        upload_bytes = 0
        for t0, tc in chunk_grid:
            samples = read(t0 * hop, (tc - 1) * hop + win_len)
            x = upload(samples)
            x = pcm_to_float(x) if use_pcm_in else x
            spec = stft_ops.stft(x, self._window, hop, conjugate=True,
                                 method=self._stft_method)  # (2, tc, F)
            coh = gcc.coherence(spec, guard_zeros=True)
            ang_acc += gcc.angular_spectrogram(coh, self._cos, self._sin).sum(dim=0)
            spec_re[:, t0 : t0 + tc] = spec.real
            spec_im[:, t0 : t0 + tc] = spec.imag
            v_buf[:, t0 : t0 + tc] = spec.abs()
            trimmer.account(samples.nbytes)
            upload_bytes += samples.nbytes
        t_pass1_done = time.perf_counter()
        ang_host = ang_acc.cpu().numpy().astype(np.float64)  # waits for pass 1
        t_pass1_fenced = time.perf_counter()

        # ---- NMF over V in the reference's left‖right row order: the
        # (2, T, F) → (2T, F) reshape is exactly that
        w0, h0 = self._h0_device_chunked(2 * t_total)
        w, h = self._run_nmf(v_buf.reshape(2 * t_total, f), w0, h0)
        del v_buf, h0

        mean_ang = ang_host / t_total
        targets = localize.estimate_target_tdoa_indexes(mean_ang, num_sources)
        targets_t = torch.tensor(targets, dtype=torch.long, device=dev)
        n_targets = len(targets)
        gain = stft_gain(cfg)

        # ---- pass 2: chunked reconstruction with an overlap-add seam carry
        def reconstruct(t0: int, tc: int, carry: torch.Tensor):
            """Chunk ``[t0, t0 + tc)`` → (int16 PCM (N, 2, tc·hop), clip
            tally (N,), the pre-gain f32 seam for the next chunk)."""
            spec = torch.complex(spec_re[:, t0 : t0 + tc].float(),
                                 spec_im[:, t0 : t0 + tc].float())  # (2, tc, F)
            # the coherence from the planes as stored, as JAX recomputes it
            coh = gcc.coherence(spec, guard_zeros=True)
            h_l = torch.stack([h[t0 : t0 + tc], h[t_total + t0 : t_total + t0 + tc]])
            coef = masks.hard_coefficient_masks(
                masks.target_attribution(coh, self._cos, self._sin, targets_t, w))
            y = torch.stack([self._synthesize(coef[n], spec, w, h_l) for n in range(n_targets)])
            y[..., :overlap] += carry
            scaled = y[..., : tc * hop] * gain
            # the writer's |x| >= 1 tally, taken before the quantization
            clips = (scaled.abs() >= 1.0).sum(dim=(1, 2)).to(torch.int32)
            return float_to_pcm(scaled), clips, y[..., tc * hop :].clone()

        downloads = (_PinnedRing(LOOKAHEAD + 1, [(n_targets, 2, tc_main * hop), (n_targets,)],
                                 [torch.int16, torch.int32], dev) if cuda else None)

        def download(pcm: torch.Tensor, clips: torch.Tensor):
            """Queue the copy of a chunk's output to the host; returns what
            :func:`drain_one` needs to read it."""
            if not cuda:
                return pcm.numpy(), clips.numpy(), None
            slot, (host_pcm, host_clips) = downloads.take()
            host_pcm = host_pcm[..., : pcm.shape[-1]]
            host_pcm.copy_(pcm, non_blocking=True)
            host_clips.copy_(clips, non_blocking=True)
            return host_pcm.numpy(), host_clips.numpy(), downloads.mark(slot)

        prefix = output_prefix or wav.default_output_prefix(mixture_path)
        half = win_len // 2
        writers = [wav.StreamingWavWriter(f"{prefix}_sim_{i + 1}.wav", reader.sample_rate)
                   for i in range(n_targets)]
        # held-back FIFO per target: the last `half` samples are trimmed, and
        # which samples those are is known only at the end
        pending = [np.zeros((2, 0), np.int16) for _ in range(n_targets)]
        # device-counted clips not yet handed to a writer (emit may hold
        # samples back while it waits for the trim boundary)
        clip_owed = np.zeros(max(n_targets, 1), np.int64)

        def emit(block: np.ndarray) -> None:
            for n in range(n_targets):  # block: (N, 2, L) int16 PCM
                buf = np.concatenate([pending[n], block[n]], axis=-1)
                cut = buf.shape[-1] - half
                if cut > 0:
                    writers[n].write_pcm(buf[:, :cut], int(clip_owed[n]))
                    clip_owed[n] = 0
                    buf = buf[:, cut:]
                pending[n] = buf

        inflight: list = []
        lead = half  # leading samples still to trim (may span chunks)
        t_first_output = None
        download_bytes = 0

        def drain_one() -> None:
            nonlocal lead, t_first_output, download_bytes
            block, clips, done = inflight.pop(0)
            if done is not None:
                done.synchronize()
            if t_first_output is None:
                t_first_output = time.perf_counter()
            download_bytes += block.nbytes
            trimmer.account(block.nbytes)
            clip_owed[:n_targets] += clips.astype(np.int64)
            drop = min(lead, block.shape[-1])
            if drop:
                block = block[..., drop:]
                lead -= drop
            if block.shape[-1]:
                emit(block)

        carry = torch.zeros((n_targets, 2, overlap), dtype=torch.float32, device=dev)
        for t0, tc in chunk_grid:
            pcm, clips, carry = reconstruct(t0, tc, carry)
            inflight.append(download(pcm, clips))
            if len(inflight) > LOOKAHEAD:
                drain_one()
        while inflight:
            drain_one()
        # final flush: the held-back PCM through write_pcm (its clips were
        # counted on the device), the trailing seam (pre-gain float, never
        # counted) through the writer's own conversion. A leading trim not
        # yet consumed (audio shorter than window/2) lands here.
        tail = carry.cpu().numpy()[..., lead:] * gain
        for n in range(n_targets):
            cut = pending[n].shape[-1] + tail[n].shape[-1] - half
            if cut > 0:
                take_pcm = min(cut, pending[n].shape[-1])
                if take_pcm:
                    writers[n].write_pcm(pending[n][:, :take_pcm], int(clip_owed[n]))
                    clip_owed[n] = 0
                if cut > take_pcm:
                    writers[n].write(tail[n][:, : cut - take_pcm])
            if clip_owed[n]:  # tallies whose samples the trim removed
                writers[n].write_pcm(np.zeros((2, 0), np.int16), int(clip_owed[n]))
                clip_owed[n] = 0
        paths = [w_.close() for w_ in writers]
        # leave the heap trimmed, so back-to-back runs start from a flat floor
        trimmer.account(trimmer.every_bytes)
        t_end = time.perf_counter()
        first = t_first_output or t_pass1_fenced
        return dict(
            paths=paths,
            target_tdoa_indexes=targets,
            w=w.cpu().numpy(),
            mean_angular_spectrum=mean_ang,
            frames_processed=t_total,
            samples_written=writers[0].samples_written if writers else 0,
            host_heap_trims=trimmer.trims,
            # pass1_dispatch: the host loop of pass 1; pass1_upload_fence:
            # waiting for the device to finish it; nmf_to_first_output: the
            # NMF and pass 2 up to the first chunk on the host; output_drain:
            # the rest of pass 2 and the writes
            stage_seconds=dict(
                pass1_dispatch=t_pass1_done - t_start,
                pass1_upload_fence=t_pass1_fenced - t_pass1_done,
                nmf_to_first_output=first - t_pass1_fenced,
                output_drain=t_end - first,
            ),
            transfer_mb=dict(uploads=upload_bytes / 1e6, downloads=download_bytes / 1e6),
        )
