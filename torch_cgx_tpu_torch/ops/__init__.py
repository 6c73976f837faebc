"""The max-min codec: wire format (``codec``), CUDA kernels and their plain
versions (``codec_cuda``), and the dispatcher the reducers call
(``dispatch``)."""

from . import codec, codec_cuda, dispatch

__all__ = ["codec", "codec_cuda", "dispatch"]
