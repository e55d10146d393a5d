"""Native (C++) host-runtime tier for the realtime audio path (counterpart
of ``gccnmf_tpu/native``).

See :mod:`gccnmf_torch.native.runtime` for the public surface and
``src/gccnmf_rt.cpp`` for the implementation. The library is built lazily
on first use into ``gccnmf_torch/build/``; without a C++ toolchain every
consumer takes the NumPy path.
"""

from gccnmf_torch.native.runtime import (  # noqa: F401
    BlockTimes,
    OverlapAdd,
    SpscRing,
    available,
    deinterleave_pcm16,
    float_to_pcm16,
    interleave_pcm16,
    pcm16_to_float,
)
