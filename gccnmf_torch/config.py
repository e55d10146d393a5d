"""Layered typed configuration (counterpart of ``gccnmf_tpu/config.py``).

The reference's config stack is INI-style defaults plus typed extraction
into a frozen namedtuple (realtime/config.py:46-120); its config-*file*
loader is dead code (config.py:104-105). Here the layering works end to end:

    defaults  <  config file ([TDOA]/[Audio]/[STFT]/[NMF] sections,
                 the reference's camelCase option names)  <  CLI overrides

and resolves into the frozen dataclass the entry points consume.
"""

from __future__ import annotations

import ast
import configparser
import logging
from dataclasses import dataclass, field, fields, replace
from typing import Any

logger = logging.getLogger(__name__)

__all__ = ["GCCNMFConfig", "load_config", "default_config"]


@dataclass(frozen=True)
class GCCNMFConfig:
    """Full framework configuration (reference defaults,
    realtime/config.py:46-73)."""

    # [TDOA]
    num_tdoas: int = 64
    num_tdoa_history: int = 128
    num_spectrogram_history: int = 128
    gcc_phat_nl_alpha: float = 2.0
    gcc_phat_nl_enabled: bool = False
    microphone_separation_in_metres: float = 0.1
    target_tdoa_epsilon: float = 5.0
    target_tdoa_beta: float = 2.0
    target_tdoa_noise_floor: float = 0.0
    localization_enabled: bool = True
    localization_window_size: int = 6
    # "window" (generalized-Gaussian soft mask, reference
    # TARGET_MODE_WINDOW_FUNCTION=2) or "boxcar" (TARGET_MODE_BOXCAR=0);
    # the reference's integer constants are accepted. TARGET_MODE_MULTIPLE
    # is a documented non-port (PARITY.md).
    target_mode: str = "window"

    # [Audio]
    num_channels: int = 2
    sample_rate: int = 16000
    device_index: int | None = None

    # [STFT]
    window_size: int = 1024
    hop_size: int = 512
    block_size: int = 512

    # [NMF]
    dictionary_size: int = 64
    dictionary_sizes: tuple = (64, 128, 256, 512, 1024)
    dictionary_type: str = "Pretrained"
    # explicit dictionary artifact (.npy, (F, K)): bypasses pretraining and
    # the corpus-keyed cache entirely — the production handoff from
    # `gccnmf-pretrain --save-dir` to every serving/streaming entry point
    dictionary_file: str | None = None
    num_h_updates: int = 0

    # paths
    audio_path: str | None = None

    @property
    def num_freq(self) -> int:
        return self.window_size // 2 + 1

    @property
    def windows_per_block(self) -> int:
        return self.block_size // self.hop_size


# INI option name (reference spelling) -> dataclass field
_OPTION_MAP = {
    "numTDOAs": "num_tdoas",
    "numTDOAHistory": "num_tdoa_history",
    "numSpectrogramHistory": "num_spectrogram_history",
    "gccPHATNLAlpha": "gcc_phat_nl_alpha",
    "gccPHATNLEnabled": "gcc_phat_nl_enabled",
    "microphoneSeparationInMetres": "microphone_separation_in_metres",
    "targetTDOAEpsilon": "target_tdoa_epsilon",
    "targetTDOABeta": "target_tdoa_beta",
    "targetTDOANoiseFloor": "target_tdoa_noise_floor",
    "localizationEnabled": "localization_enabled",
    "localizationWindowSize": "localization_window_size",
    "targetMode": "target_mode",
    "numChannels": "num_channels",
    "sampleRate": "sample_rate",
    "deviceIndex": "device_index",
    "windowSize": "window_size",
    "hopSize": "hop_size",
    "blockSize": "block_size",
    "dictionarySize": "dictionary_size",
    "dictionaryFile": "dictionary_file",
    "dictionarySizes": "dictionary_sizes",
    "dictionaryType": "dictionary_type",
    "numHUpdates": "num_h_updates",
    "audioPath": "audio_path",
}

_FIELD_TYPES = {f.name: f.type for f in fields(GCCNMFConfig)}


def _coerce(name: str, raw: str | None) -> Any:
    t = _FIELD_TYPES[name]
    # allow_no_value=True hands bare options through as None; treat them
    # like an explicit empty value
    raw = "" if raw is None else raw.strip()
    if raw.lower() in ("none", ""):
        if "None" not in t:
            raise ValueError(
                f"config option {name!r} ({t}) cannot be empty/none"
            )
        return None
    if t == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if t == "int":
        return int(raw)
    if t == "float":
        return float(raw)
    if t == "str" or t == "str | None":
        return raw
    if t == "int | None":
        return int(raw)
    if t == "tuple":
        val = ast.literal_eval(raw)
        return tuple(val) if isinstance(val, (list, tuple)) else (val,)
    return ast.literal_eval(raw)


def default_config() -> GCCNMFConfig:
    return GCCNMFConfig()


def load_config(path: str | None = None, **overrides) -> GCCNMFConfig:
    """Load defaults, then optional INI file, then keyword overrides."""
    cfg = GCCNMFConfig()
    if path:
        parser = configparser.ConfigParser(allow_no_value=True)
        parser.optionxform = str  # preserve reference camelCase option names
        read = parser.read(path)
        if not read:
            raise FileNotFoundError(f"config file not found: {path}")
        updates: dict[str, Any] = {}
        for section in parser.sections():
            for option in parser.options(section):
                if option not in _OPTION_MAP:
                    logger.warning("unknown config option %s.%s", section, option)
                    continue
                name = _OPTION_MAP[option]
                updates[name] = _coerce(name, parser.get(section, option))
        cfg = replace(cfg, **updates)
    if overrides:
        cfg = replace(cfg, **{k: v for k, v in overrides.items() if v is not None})
    return cfg
