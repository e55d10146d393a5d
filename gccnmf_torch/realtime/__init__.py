"""Real-time runtime: audio sources and sinks, history buffers, headless
app shell (counterpart of ``gccnmf_tpu/realtime``).

The compute engine itself lives in :mod:`gccnmf_torch.models.realtime`; this
package is the surrounding runtime — one host process in place of the
reference's three OS processes (reference:
gccNMF/realtime/{runRealtimeGCCNMF,audioProcessor,utils}.py).
"""

from gccnmf_torch.realtime.buffers import CircularBuffer
from gccnmf_torch.realtime.audio import FilePlayerSource, WavSink
from gccnmf_torch.realtime.app import RealtimeGCCNMF

__all__ = ["CircularBuffer", "FilePlayerSource", "WavSink", "RealtimeGCCNMF"]
