"""Global constants and data paths (counterpart of ``gccnmf_tpu/defs.py``).

Reference: gccNMF/defs.py (speed of sound at defs.py:41, data-dir env
override at defs.py:30-37).
"""

import os
from os.path import abspath, dirname, join

# Same physical constant as the reference (gccNMF/defs.py:41) so TDOA grids
# line up exactly for waveform parity.
SPEED_OF_SOUND_M_S = 340.29

ROOT_DIR = abspath(join(dirname(__file__), ".."))

# ``GCCNMF_TPU_DATA_DIR`` is shared with the JAX package so one setting
# points both at the same WAVs.
DATA_DIR = os.environ.get("GCCNMF_TPU_DATA_DIR") or join(ROOT_DIR, "data")

DEFAULT_AUDIO_FILE = join(DATA_DIR, "dev_Sq1_Co_A_mix.wav")
DEFAULT_SEPARATION_FILE = join(DATA_DIR, "dev1_female3_liverec_130ms_1m_mix.wav")

# Cache dir for pre-learned NMF dictionaries (reference:
# gccNMF/realtime/gccNMFPretraining.py:36-37 uses data/pretrainedW/W_<size>.npy).
# ``GCCNMF_TPU_CACHE_DIR`` is shared with the JAX package too, and so is the
# cache key (``pretrain.pretrain_dictionary``).
PRETRAINED_W_DIR = os.environ.get(
    "GCCNMF_TPU_CACHE_DIR", join(ROOT_DIR, ".cache", "pretrainedW")
)
