"""Command-line entry points of the port (counterparts of ``gccnmf-separate``,
``gccnmf-enhance``, ``gccnmf-stream``, ``gccnmf-realtime``, ``gccnmf-serve``
and ``gccnmf-pretrain`` in ``gccnmf_tpu/cli.py``):

    python -m gccnmf_torch.cli mix_a.wav [mix_b.wav ...] [--turbo] [--auto-sources]
    python -m gccnmf_torch.cli long_mix.wav --streamed [--chunk-frames 8192] [--device-init]
    python -m gccnmf_torch.cli long_mix.wav --time-shards 4 [--streamed]
    python -m gccnmf_torch.cli enhance a.wav [b.wav ...] [--mode online|offline] [-o out.wav]
    python -m gccnmf_torch.cli stream -i mix.wav [-o out.wav] [--low-latency] [--realtime]
    python -m gccnmf_torch.cli realtime -i mix.wav [-o out.wav] [--pipeline-depth 2] [--gui]
    python -m gccnmf_torch.cli serve -i a.wav b.wav ... [--wire-dtype int16]
    python -m gccnmf_torch.cli pretrain corpus/*.wav [--sizes 64 128 256] [--save-dir DIR]
                                        [--data-shards 4]

The first separates stereo WAVs offline (the reference's ``runGCCNMF.py``),
writing ``<prefix>_sim_<n>.wav`` per source; with ``--streamed`` it streams
a file of any length from disk through the long-audio pipeline on one
device, and ``--time-shards 1`` runs that pipeline in memory;
``--time-shards N`` splits the time axis over a world of N ranks, one a
device (in memory, or with ``--streamed`` each rank reading its own range
of the file). ``enhance`` writes ``<input>_enhanced.wav`` per WAV, with the
online (causal) enhancer or the offline one; ``stream`` enhances one WAV
block by block (the reference's ``runRealtimeGCCNMF.py --no-gui``);
``realtime`` runs the realtime app over a WAV (or the live audio device)
with live parameters and telemetry, headless or with ``--gui`` in its
window (the reference's ``runRealtimeGCCNMF.py``); ``serve`` enhances one
stream per WAV in lockstep ticks; ``pretrain`` learns
dictionaries from a WAV corpus into the corpus-keyed cache and, with
``--save-dir``, into ``W_<size>.npy`` files, over a world of N ranks with
``--data-shards N``. The worlds start through ``parallel.launch.run_world``
(under torchrun, the running world). Each command runs on the card unless
``--device cpu`` is given and prints one JSON line (rank 0 alone, over a
world), with the JAX commands' keys. ``enhance``, ``stream``, ``realtime``
and ``serve`` take their dictionary from ``--dictionary-file`` (or the INI's
``dictionaryFile``), else from the pretraining cache.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

__all__ = ["separate_main", "enhance_main", "stream_main", "realtime_main", "serve_main",
           "pretrain_main", "main"]



def separate_main(argv=None):
    ap = argparse.ArgumentParser(description="Offline GCC-NMF source separation")
    ap.add_argument("input", nargs="+",
                    help="stereo mixture WAV(s) (<prefix>_mix.wav); several files "
                         "reuse one separator")
    ap.add_argument("-o", "--output-prefix", default=None,
                    help="output prefix; with multiple inputs each file's "
                         "stem is appended")
    ap.add_argument("--num-sources", type=int, default=3)
    ap.add_argument("--auto-sources", action="store_true",
                    help="detect source count by clustering peak heights")
    ap.add_argument("--window-size", type=int, default=1024)
    ap.add_argument("--hop-size", type=int, default=128)
    ap.add_argument("--num-tdoas", type=int, default=128)
    ap.add_argument("--mic-separation", type=float, default=1.0)
    ap.add_argument("--dictionary-size", type=int, default=128)
    ap.add_argument("--num-iterations", type=int, default=100)
    ap.add_argument("--sparsity-alpha", type=float, default=0.0)
    ap.add_argument("--turbo", action="store_true",
                    help="shared-Q simultaneous NMF updates: one ratio an "
                         "iteration instead of two, a different update "
                         "trajectory than the reference (not the parity path)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--time-shards", type=int, default=0,
                    help="the long-audio pipeline over N time shards, one a device: 1 "
                         "runs it on one device, N > 1 over a world of N ranks")
    ap.add_argument("--streamed", action="store_true",
                    help="disk-streamed I/O for hour-scale files: input read by "
                         "range, outputs written as they come, O(chunk) host RAM; "
                         "sequential macro-chunks on one device, or each shard's "
                         "range read by its rank")
    ap.add_argument("--chunk-frames", type=int, default=8192,
                    help="macro-chunk width in STFT frames for --streamed (bounds "
                         "host RAM and device transients)")
    ap.add_argument("--device-init", action="store_true",
                    help="with --streamed or --time-shards: draw the NMF H0 on the "
                         "device (a generator seeded with 0) instead of uploading the "
                         "reference's host-seeded init; deterministic but another "
                         "trajectory than the reference (not the parity path)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)
    if args.streamed and not args.time_shards:
        args.time_shards = 1  # the one-device macro-chunk path
    if args.device_init and not args.time_shards:
        # the flag exists only on the long-audio path; running the seeded
        # init the user opted out of would be worse than an error
        ap.error("--device-init requires --streamed or --time-shards")
    if args.time_shards > 1:
        from gccnmf_torch.parallel.launch import run_world

        out = run_world(_separate_rank, args.time_shards, args.device, args)
    else:
        out = _separate_files(args)
    if out is not None:  # rank 0 prints
        print(json.dumps(out))
    return 0


def _separate_rank(args):
    """One rank of ``separate --time-shards N``: every file over a mesh of
    N data ranks."""
    from gccnmf_torch.parallel import mesh as mesh_lib

    return _separate_files(args, mesh_lib.make_mesh(data=args.time_shards, device=args.device))


def _separate_files(args, mesh=None) -> dict:
    """The separate command's files → the JSON it prints."""
    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
    from gccnmf_torch.parallel.long_audio import LongAudioSeparator
    from gccnmf_torch.utils import wav

    def make_separator(sr):
        cfg = OfflineConfig(
            window_size=args.window_size,
            hop_size=args.hop_size,
            num_tdoas=args.num_tdoas,
            mic_separation_m=args.mic_separation,
            dictionary_size=args.dictionary_size,
            num_iterations=args.num_iterations,
            sparsity_alpha=args.sparsity_alpha,
            **({"nmf_matmul_dtype": "bfloat16_q_simul"} if args.turbo else {}),
            num_sources=None if args.auto_sources else args.num_sources,
            sample_rate=sr,
        )
        if args.time_shards:
            return LongAudioSeparator(
                cfg, device=args.device, chunk_frames=args.chunk_frames,
                nmf_init="device" if args.device_init else "reference", mesh=mesh,
            )
        return GCCNMFSeparator(cfg, device=args.device)

    multi = len(args.input) > 1
    separator = None
    results = []
    for path in args.input:
        if args.output_prefix is None:
            prefix = None
        elif multi:  # keep per-file outputs distinct under one prefix
            stem = os.path.splitext(os.path.basename(path))[0]
            prefix = f"{args.output_prefix}_{stem}"
        else:
            prefix = args.output_prefix
        if args.streamed:  # the header alone: the samples stay on disk
            reader = wav.WavReader(path)
            sr = reader.sample_rate
            if reader.num_channels != 2:  # the contract of _require_stereo
                raise SystemExit(
                    f"{path}: expected 2-channel audio, got {reader.num_channels} "
                    "channel(s). GCC-PHAT localization needs a stereo microphone pair."
                )
        else:
            stereo, sr = wav.read_wav(path)
            _require_stereo(stereo, path)
        if separator is None or separator.config.sample_rate != sr:
            separator = make_separator(sr)  # reused across files of one rate
        if args.streamed:
            result = separator.separate_streamed(path, prefix)
        else:
            result = separator.separate_file(path, prefix, audio=(stereo, sr))
        results.append(dict(input=path, outputs=result["paths"],
                            target_tdoa_indexes=result["target_tdoa_indexes"]))
    if multi:
        return dict(files=results)
    results[0].pop("input")  # single file: the flat JSON shape
    return results[0]


def _require_stereo(audio, path, num_channels=2):
    """Fail with the actual problem (the channel count) at the CLI boundary:
    GCC-PHAT needs a microphone pair, and a mono file would otherwise fail
    deep inside the pipeline with a shape error."""
    shape = np.shape(audio)
    if len(shape) != 2 or shape[0] != num_channels:
        raise SystemExit(
            f"{path}: expected {num_channels}-channel audio, got shape "
            f"{shape} (GCC-PHAT needs a stereo microphone pair)"
        )


def _resolve_dictionary(cfg, size=None, device=None) -> np.ndarray:
    """The explicit artifact (``cfg.dictionary_file``) wins; otherwise the
    corpus-keyed pretraining cache, trained on ``device`` on a miss."""
    from gccnmf_torch import pretrain

    if cfg.dictionary_file:
        return pretrain.load_dictionary_file(cfg.dictionary_file, cfg.num_freq)
    size = size or cfg.dictionary_size
    banks = pretrain.get_dictionaries(cfg.window_size, sizes=(size,), device=device)
    return banks[cfg.dictionary_type][size]


def enhance_main(argv=None):
    ap = argparse.ArgumentParser(description="GCC-NMF speech enhancement")
    ap.add_argument("input", nargs="+",
                    help="stereo WAV(s). The NMF dictionary is resolved once "
                         "(--dictionary-file, else the corpus-pretrained cache; "
                         "never trained on the input audio) and reused for every file")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (single input only; multiple inputs "
                         "write <input>_enhanced.wav next to each file)")
    ap.add_argument("--mode", choices=["offline", "online"], default="online")
    ap.add_argument("-c", "--config", default=None, help="INI config file")
    ap.add_argument("--dictionary-size", type=int, default=None)
    ap.add_argument("--dictionary-file", default=None,
                    help=".npy (F, K) dictionary artifact (bypasses "
                         "pretraining; e.g. from pretrain --save-dir)")
    ap.add_argument("--num-h-updates", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)

    from gccnmf_torch.config import load_config
    from gccnmf_torch.utils import wav

    if args.output is not None and len(args.input) > 1:
        ap.error("-o/--output only applies to a single input")
    cfg = load_config(
        args.config,
        dictionary_size=args.dictionary_size,
        dictionary_file=args.dictionary_file,
        num_h_updates=args.num_h_updates,
        audio_path=args.input[0],
    )
    w = _resolve_dictionary(cfg, device=args.device)

    enhancers = {}  # one per sample rate, reused across files
    outputs = []
    for path in args.input:
        stereo, sr = wav.read_wav(path)
        _require_stereo(stereo, path)
        if sr not in enhancers:
            enhancers[sr] = _make_enhancer(args.mode, cfg, w, sr, args.device)
        out = enhancers[sr].enhance(stereo)["enhanced"]
        out_path = args.output or os.path.splitext(path)[0] + "_enhanced.wav"
        wav.write_wav(out, out_path, sr)
        outputs.append(out_path)
    if len(outputs) == 1:  # the flat JSON shape
        print(json.dumps(dict(output=outputs[0])))
    else:
        print(json.dumps(dict(outputs=outputs)))
    return 0


def _make_enhancer(mode, cfg, w, sr, device):
    """The online or offline enhancer of ``cfg`` (a ``GCCNMFConfig``) at
    sample rate ``sr``, as ``gccnmf-enhance`` builds it."""
    if mode == "online":
        from gccnmf_torch.models.online import OnlineConfig, OnlineGCCNMFEnhancer

        ocfg = OnlineConfig(
            sample_rate=sr,
            window_size=cfg.window_size,
            hop_size=cfg.hop_size,
            num_tdoas=cfg.num_tdoas,
            mic_separation_m=cfg.microphone_separation_in_metres,
            num_h_updates=cfg.num_h_updates,
            smoothing_window=cfg.localization_window_size,
            target_epsilon=cfg.target_tdoa_epsilon,
            target_beta=cfg.target_tdoa_beta,
            noise_floor=cfg.target_tdoa_noise_floor,
        )
        return OnlineGCCNMFEnhancer(w, ocfg, device=device)
    from gccnmf_torch.models.offline import GCCNMFEnhancer, OfflineConfig

    ecfg = OfflineConfig(
        window_size=cfg.window_size,
        hop_size=cfg.hop_size,
        num_tdoas=cfg.num_tdoas,
        mic_separation_m=cfg.microphone_separation_in_metres,
        sample_rate=sr,
    )
    return GCCNMFEnhancer(
        w,
        ecfg,
        target_epsilon=cfg.target_tdoa_epsilon,
        target_beta=cfg.target_tdoa_beta,
        noise_floor=cfg.target_tdoa_noise_floor,
        num_h_updates=cfg.num_h_updates,
        device=device,
    )


def stream_main(argv=None):
    """Headless streaming enhancement (the --no-gui realtime mode)."""
    ap = argparse.ArgumentParser(description="Streaming RT-GCC-NMF enhancement")
    ap.add_argument("-i", "--input", required=True, help="input WAV path")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-c", "--config", default=None, help="INI config file")
    ap.add_argument("--reference-delay", action="store_true",
                    help="reproduce the reference's 2-block output delay")
    ap.add_argument("--low-latency", action="store_true",
                    help="asymmetric analysis/synthesis windows, emitting "
                         "every hop (block_size = hop)")
    ap.add_argument("--synthesis-length", type=int, default=256,
                    help="synthesis-window support for --low-latency mode; "
                         "the hop is clamped to synthesis_length/2 so the "
                         "COLA condition holds")
    ap.add_argument("--block-size", type=int, default=None,
                    help="samples per emitted block (must be a multiple of "
                         "the hop); defaults to the config block size, or to "
                         "one hop in --low-latency mode")
    ap.add_argument("--realtime", action="store_true",
                    help="host-loop block-by-block with deadline telemetry")
    ap.add_argument("--dictionary-file", default=None,
                    help=".npy (F, K) dictionary artifact")
    ap.add_argument("--num-h-updates", type=int, default=None,
                    help="per-block H-inference steps against the frozen "
                         "dictionary (H-aware Wiener mask); 0 = the "
                         "reference's W-only realtime rule. Also settable "
                         "as numHUpdates in the INI config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)

    from gccnmf_torch.config import load_config
    from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig, StreamParams
    from gccnmf_torch.utils import wav

    overrides = {}
    if args.num_h_updates is not None:
        if args.num_h_updates < 0:
            ap.error("--num-h-updates must be >= 0")
        overrides["num_h_updates"] = args.num_h_updates
    cfg = load_config(args.config, audio_path=args.input,
                      dictionary_file=args.dictionary_file, **overrides)

    # Flag validation needs only the config: do it before loading anything.
    # Low-latency mode needs hop <= synthesis_length/2 for COLA, and emits
    # every hop (block_size = hop) unless told otherwise.
    hop = cfg.hop_size
    if args.low_latency:
        if args.synthesis_length < 2:
            ap.error("--synthesis-length must be >= 2 (got %d)" % args.synthesis_length)
        hop = min(hop, args.synthesis_length // 2)
    block = args.block_size
    if block is None:
        block = hop if args.low_latency else cfg.block_size
    elif block < 1 or block % hop != 0:
        ap.error("--block-size %d is not a positive multiple of the hop (%d)" % (block, hop))

    stereo, sr = wav.read_wav(args.input)
    _require_stereo(stereo, args.input)
    if stereo.shape[-1] < block:
        ap.error("input is shorter than one %d-sample block" % block)
    w = _resolve_dictionary(cfg, device=args.device)
    scfg = StreamConfig.from_app_config(
        cfg,
        sample_rate=sr,
        hop_size=hop,
        block_size=block,
        synthesis_length=args.synthesis_length,
        extra_delay_blocks=1 if args.reference_delay else 0,
        analysis_window="asymmetric" if args.low_latency else "sqrt_hamming",
    )
    params = StreamParams.default(
        # broadside for this grid: with localization off this is the mask center
        target_tdoa_index=scfg.num_tdoas / 2.0,
        target_epsilon=cfg.target_tdoa_epsilon,
        target_beta=cfg.target_tdoa_beta,
        noise_floor=cfg.target_tdoa_noise_floor,
        localization_enabled=cfg.localization_enabled,
        localization_window=cfg.localization_window_size,
        device=args.device,
    )
    proc = RTGCCNMFProcessor(w, scfg, device=args.device)

    if args.realtime:
        import time

        import torch

        blocks = proc.blocks_from_signal(stereo)
        state = proc.init_state(1)
        outs, times = [], []
        for i in range(blocks.shape[0]):
            t0 = time.perf_counter()
            state, out, _ = proc.step(state, torch.from_numpy(blocks[i]), params)
            if proc.device.type == "cuda":
                torch.cuda.synchronize(proc.device)
            times.append(time.perf_counter() - t0)
            outs.append(out.cpu().numpy())
        out = np.concatenate([o[0] for o in outs], axis=-1)
        deadline = scfg.block_size / sr
        stats = dict(
            p50_ms=round(float(np.percentile(times, 50)) * 1e3, 3),
            p99_ms=round(float(np.percentile(times, 99)) * 1e3, 3),
            deadline_ms=round(deadline * 1e3, 3),
            deadline_misses=int(np.sum(np.asarray(times) > deadline)),
            blocks=len(times),
        )
    else:
        out = proc.enhance_signal(stereo, params)[0]
        stats = dict(blocks=out.shape[-1] // scfg.block_size)

    out_path = args.output or os.path.splitext(args.input)[0] + "_rtenhanced.wav"
    wav.write_wav(out, out_path, sr)
    print(json.dumps(dict(
        output=out_path,
        algorithmic_latency_ms=round(scfg.algorithmic_latency_s * 1e3, 3),
        **stats,
    )))
    return 0


def realtime_main(argv=None):
    """The realtime app (reference runRealtimeGCCNMF.py; its argparse
    surface at realtime/config.py:122-127): headless by default, the
    window with ``--gui``."""
    ap = argparse.ArgumentParser(description="Realtime GCC-NMF app (headless)")
    ap.add_argument("-i", "--input", default=None, help="input WAV path")
    ap.add_argument("-c", "--config", default=None, help="INI config file")
    ap.add_argument("-o", "--output", default=None, help="output WAV path")
    ap.add_argument("--no-gui", action="store_true",
                    help="accepted for reference-CLI compatibility; headless "
                         "is the default")
    ap.add_argument("--gui", action="store_true",
                    help="open the interactive tkinter/matplotlib window "
                         "(requires a display)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="stop after N blocks (default: whole file)")
    ap.add_argument("--loop", action="store_true", help="loop the input file")
    ap.add_argument("--no-loop", action="store_true",
                    help="with --gui: stop at end of file instead of looping "
                         "(the GUI loops by default, like the reference's "
                         "realtime window, audioProcessor.py:109-110)")
    ap.add_argument("--realtime-pace", action="store_true",
                    help="pace blocks at the 32 ms deadline")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="blocks of dispatch pipelining: N>0 removes the "
                         "host<->device round trip from the per-block "
                         "deadline path at the cost of N blocks of extra "
                         "latency (output file is identical)")
    ap.add_argument("--dictionary-file", default=None,
                    help=".npy (F, K) dictionary artifact (bypasses "
                         "pretraining; e.g. from pretrain --save-dir)")
    ap.add_argument("--live", action="store_true",
                    help="capture input from the live audio device instead "
                         "of a WAV file (requires a host audio stack, e.g. "
                         "sounddevice; reference audioProcessor.py input "
                         "callback)")
    ap.add_argument("--live-output", action="store_true",
                    help="play enhanced audio through the live output "
                         "device when a host audio stack exists (reference "
                         "audioProcessor.py:106-132); falls back to "
                         "--output/-o (or discard) otherwise")
    ap.add_argument("--streamed-output", action="store_true",
                    help="write -o incrementally (O(block) host RAM for "
                         "hour-scale runs; per-sample clipping instead of "
                         "the whole-file clip rescale)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)
    from gccnmf_torch.config import load_config

    cfg = load_config(args.config, audio_path=args.input,
                      dictionary_file=args.dictionary_file)
    if args.gui:
        from gccnmf_torch.gui import run_gui

        # GUI loops playback by default like the reference realtime window
        # (audioProcessor.py:109-110 wraps sampleIndex to 0); --no-loop opts
        # out. The built config carries --dictionary-file through.
        run_gui(args.input, config=cfg, loop=not args.no_loop, device=args.device)
        return 0
    source = None
    if args.live:
        from gccnmf_torch.realtime.audio import open_input_stream

        source = open_input_stream(
            cfg.sample_rate, cfg.num_channels, cfg.block_size
        )
        if source is None:
            ap.error(
                "--live requires a host audio stack (sounddevice); none is "
                "available — use -i <wav> for file input"
            )
        if args.blocks is None:
            ap.error("--live requires --blocks (otherwise the run never ends)")
    elif args.loop and args.blocks is None:
        ap.error("--loop requires --blocks (otherwise the run never ends)")

    from gccnmf_torch.realtime.app import RealtimeGCCNMF

    app = RealtimeGCCNMF(
        args.input, config=cfg, pipeline_depth=args.pipeline_depth, device=args.device
    )
    try:
        stats = app.run(
            output_path=args.output,
            num_blocks=args.blocks,
            loop=args.loop,
            realtime=args.realtime_pace,
            source=source,
            live_output=args.live_output,
            streamed_output=args.streamed_output,
        )
    finally:
        if source is not None:
            source.close()
    print(json.dumps(stats))
    return 0


def serve_main(argv=None):
    """Multi-stream serving: one stream per input WAV, lockstep ticks.
    Streams whose files end close early; ticks continue until all drain."""
    ap = argparse.ArgumentParser(description="Multi-stream GCC-NMF server")
    ap.add_argument("-i", "--inputs", nargs="+", required=True,
                    help="input WAV paths (one stream each)")
    ap.add_argument("-o", "--output-dir", default=".",
                    help="directory for <name>_enhanced.wav outputs")
    ap.add_argument("-c", "--config", default=None, help="INI config file")
    ap.add_argument("--dictionary-file", default=None,
                    help=".npy (F, K) dictionary artifact")
    ap.add_argument("--max-streams", type=int, default=None,
                    help="slot count (default: number of inputs)")
    ap.add_argument("--dictionary-size", type=int, default=None,
                    help="atoms of the pretrained dictionary (without "
                         "--dictionary-file)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="stop each stream after N blocks")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ticks of dispatch pipelining: N>0 moves the "
                         "host<->device round trip off the tick deadline "
                         "path at the cost of N blocks of serving latency; "
                         "0 restores strictly synchronous ticks")
    ap.add_argument("--sync-fetch", action="store_true",
                    help="block each tick on its due output instead of "
                         "fetching on the consumer thread (diagnostic)")
    ap.add_argument("--wire-dtype", choices=["float32", "int16"], default="float32",
                    help="int16 ships tick blocks/outputs as 16-bit PCM "
                         "(half the link bytes); outputs are quantized exactly "
                         "as the WAV writer would quantize them")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="serve on the card (default) or on the CPU")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)

    from gccnmf_torch.config import load_config
    from gccnmf_torch.models.realtime import StreamConfig
    from gccnmf_torch.serving import StreamServer, StreamSettings
    from gccnmf_torch.utils import wav as wavio

    cfg = load_config(args.config, dictionary_file=args.dictionary_file)
    scfg = StreamConfig.from_app_config(cfg)
    if args.max_streams is not None and args.max_streams < len(args.inputs):
        # every input holds a slot for its whole run; excess inputs are not
        # queued
        ap.error(
            f"--max-streams {args.max_streams} < {len(args.inputs)} inputs "
            "(each input holds a slot for its whole run)"
        )
    w = _resolve_dictionary(cfg, size=args.dictionary_size, device=args.device)
    server = StreamServer(
        w, scfg, max_streams=args.max_streams or len(args.inputs),
        pipeline_depth=args.pipeline_depth,
        async_fetch=not args.sync_fetch,
        wire_dtype=args.wire_dtype,
        device=args.device,
    )

    streams = {}
    for path in args.inputs:
        audio, sr = wavio.read_wav(path)
        if sr != scfg.sample_rate:
            raise SystemExit(f"{path}: sample rate {sr} != {scfg.sample_rate}")
        if audio.ndim != 2 or audio.shape[0] != scfg.num_channels:
            raise SystemExit(
                f"{path}: expected {scfg.num_channels}-channel audio, got "
                f"shape {audio.shape} (GCC-PHAT needs a stereo pair)"
            )
        nb = audio.shape[-1] // scfg.block_size
        if args.blocks:
            nb = min(nb, args.blocks)
        # broadside mask center for this grid
        sid = server.open_stream(StreamSettings(target_tdoa_index=scfg.num_tdoas / 2.0))
        streams[sid] = dict(path=path, audio=audio, nb=nb, sub=0, out=[])
        if nb == 0:  # shorter than one block: nothing to process
            server.close_stream(sid)

    def collect(tick_out):
        for sid, block in tick_out.items():
            s = streams[sid]
            s["out"].append(block)
            if len(s["out"]) >= s["nb"]:
                server.close_stream(sid)

    # submissions and receipts diverge under pipelining (outputs lag by
    # pipeline_depth ticks); flush() drains the tail after the last submit
    live = {sid for sid, s in streams.items() if s["nb"] > 0}
    while live:
        subs = {}
        for sid in list(live):
            s = streams[sid]
            b = s["sub"]
            subs[sid] = s["audio"][:, b * scfg.block_size:(b + 1) * scfg.block_size]
            s["sub"] += 1
            if s["sub"] >= s["nb"]:
                live.discard(sid)
        collect(server.process(subs))
    for tick_out in server.flush():
        collect(tick_out)
    server.close()  # stop the async fetch worker

    os.makedirs(args.output_dir, exist_ok=True)
    outputs = []
    used = set()
    for sid, s in streams.items():
        name = os.path.splitext(os.path.basename(s["path"]))[0]
        stem, k = name, 1
        while stem in used:  # same-named inputs: disambiguate
            k += 1
            stem = f"{name}_{k}"
        used.add(stem)
        path = os.path.join(args.output_dir, f"{stem}_enhanced.wav")
        audio_out = (np.concatenate(s["out"], axis=-1) if s["out"]
                     else np.zeros((scfg.num_channels, 0), np.float32))
        wavio.write_wav(audio_out, path, scfg.sample_rate)
        outputs.append(path)
    print(json.dumps(dict(outputs=outputs, streams=len(streams), **server.tick_stats())))
    return 0


def pretrain_main(argv=None):
    """Pre-learn NMF dictionaries from a WAV corpus.

    Two outputs: the corpus-keyed artifact cache (reused only by runs with
    the same corpus, iterations and seed), and with ``--save-dir`` stable
    ``W_<size>.npy`` artifacts (the reference's pretrainedW naming,
    gccNMFPretraining.py:36-37) that every entry point loads via
    ``--dictionary-file`` / ``dictionaryFile``."""
    ap = argparse.ArgumentParser(
        description="Pre-learn GCC-NMF dictionaries from a WAV corpus"
    )
    ap.add_argument("wavs", nargs="+", help="training WAV paths")
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256],
                    help="dictionary sizes (atoms) to train")
    ap.add_argument("--window-size", type=int, default=1024)
    ap.add_argument("--hop-size", type=int, default=512,
                    help="corpus framing hop (the reference pretrains at window/2)")
    ap.add_argument("--num-iterations", type=int, default=None,
                    help="KL-NMF iterations (default: GCCNMF_TPU_PRETRAIN_ITERS or 100)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cap the corpus frame count (uniform subsample)")
    ap.add_argument("--cache-dir", default=None,
                    help="artifact cache directory (default: "
                         "GCCNMF_TPU_CACHE_DIR or the package cache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-dir", default=None,
                    help="also export stable W_<size>.npy artifacts here "
                         "(consumed via --dictionary-file / dictionaryFile)")
    ap.add_argument("--data-shards", type=int, default=0,
                    help="train over a world of N ranks, one a device (time-sharded "
                         "V and H, W's statistics all-reduced)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="train on the card (default) or on the CPU")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)

    from gccnmf_torch import pretrain

    corpus = pretrain.training_corpus_from_wavs(
        args.wavs, args.window_size, args.hop_size, max_frames=args.max_frames,
        device=args.device,
    )
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
    if args.data_shards:
        from gccnmf_torch.parallel.launch import run_world

        out = run_world(_pretrain_rank, args.data_shards, args.device, args, corpus)
        if out is None:  # rank 0 prints
            return 0
    else:
        out = _pretrain_sizes(args, corpus)
    trained, saved = out
    print(json.dumps(dict(
        corpus_frames=int(corpus.shape[0]),
        num_freq=int(corpus.shape[1]),
        dictionaries={str(k): v for k, v in trained.items()},
        cache_dir=args.cache_dir or "(default)",
        saved=saved,
    )))
    return 0


def _pretrain_rank(args, corpus):
    """One rank of ``pretrain --data-shards N``: every size over a mesh of N
    data ranks."""
    from gccnmf_torch.parallel import mesh as mesh_lib

    return _pretrain_sizes(args, corpus, mesh_lib.make_mesh(data=args.data_shards,
                                                            device=args.device))


def _pretrain_sizes(args, corpus, mesh=None):
    """Train (or load) each size → ``(shapes by size, the W_<size>.npy
    written)``; over a mesh, rank 0 alone writes them."""
    import torch.distributed as dist

    from gccnmf_torch import pretrain

    trained, saved = {}, []
    for size in args.sizes:
        w = pretrain.pretrain_dictionary(
            corpus, size, num_iterations=args.num_iterations,
            cache_dir=args.cache_dir, window_size=args.window_size,
            mesh=mesh, seed_value=args.seed, device=args.device,
        )
        trained[size] = list(w.shape)
        if args.save_dir:
            path = os.path.join(args.save_dir, f"W_{size}.npy")
            if mesh is None or dist.get_rank() == 0:
                np.save(path, w)
            saved.append(path)
    return trained, saved


COMMANDS = {"separate": separate_main, "enhance": enhance_main, "stream": stream_main,
            "realtime": realtime_main, "serve": serve_main, "pretrain": pretrain_main}


def main(argv=None):
    """``enhance``, ``stream``, ``realtime``, ``serve`` or ``pretrain`` as
    the first argument picks that command; anything else (a WAV path, or
    ``separate``) separates."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in COMMANDS:
        return COMMANDS[argv[0]](argv[1:])
    return separate_main(argv)


if __name__ == "__main__":
    sys.exit(main())
