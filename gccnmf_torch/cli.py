"""Command-line entry point of the port (counterpart of ``gccnmf-separate`` in
``gccnmf_tpu/cli.py``): offline separation of stereo WAVs, the reference's
``runGCCNMF.py``.

    python -m gccnmf_torch.cli mix_a.wav [mix_b.wav ...] [--turbo] [--auto-sources]

It runs on the card unless ``--device cpu`` is given, writes
``<prefix>_sim_<n>.wav`` per source and prints one JSON line: a flat object
for one input, ``{"files": [...]}`` for several.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

__all__ = ["separate_main"]

_LONG_AUDIO = (
    "is the long-audio pipeline, which is not ported yet (ROADMAP.md, Queue 1 item 6)"
)


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
                    help="time-sharded long-audio pipeline (not ported)")
    ap.add_argument("--streamed", action="store_true",
                    help="disk-streamed long-audio I/O (not ported)")
    ap.add_argument("--chunk-frames", type=int, default=None,
                    help="macro-chunk width of --streamed (not ported)")
    ap.add_argument("--device-init", action="store_true",
                    help="device-drawn NMF init of --streamed (not ported)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)
    long_audio = [flag for flag, on in (
        ("--time-shards", args.time_shards), ("--streamed", args.streamed),
        ("--chunk-frames", args.chunk_frames is not None),
        ("--device-init", args.device_init)) if on]
    if long_audio:
        raise SystemExit(f"{', '.join(long_audio)}: {_LONG_AUDIO}")

    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
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
        stereo, sr = wav.read_wav(path)
        _require_stereo(stereo, path)
        if separator is None or separator.config.sample_rate != sr:
            separator = make_separator(sr)  # reused across files of one rate
        result = separator.separate_file(path, prefix, audio=(stereo, sr))
        results.append(dict(input=path, outputs=result["paths"],
                            target_tdoa_indexes=result["target_tdoa_indexes"]))
    if multi:
        print(json.dumps(dict(files=results)))
    else:  # single file: the flat JSON shape
        results[0].pop("input")
        print(json.dumps(results[0]))
    return 0


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


if __name__ == "__main__":
    sys.exit(separate_main())
