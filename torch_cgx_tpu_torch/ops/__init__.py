"""The max-min codec: wire format (``codec``), CUDA kernels and their plain
versions (``codec_cuda``), the dispatcher the reducers call (``dispatch``)
and producer fusion, the dense backward that emits its gradient's payload
(``fused_producer``)."""

from . import codec, codec_cuda, dispatch, fused_producer

__all__ = ["codec", "codec_cuda", "dispatch", "fused_producer"]
