"""torch_cgx_tpu_torch: the PyTorch/CUDA port of ``torch_cgx_tpu``.

Quantized (1-8 bit, bucketwise max-min) data-parallel gradient sync over
``torch.distributed``, with the codec as hand-written CUDA kernels for
Hopper (``ops/codec_cuda.py``, ``csrc/codec.cu``). The layout mirrors the
JAX package's: ``ops/`` (codec, kernels, dispatch), ``parallel/``
(group, reducers, tree allreduce, training front end), ``models/``,
``utils/`` and ``config.py``. This package never imports JAX or the JAX
package, and it registers no c10d backend.
"""

from .config import (
    CompressionConfig,
    clear_registry,
    register_layer,
    set_layer_pattern_config,
)

__all__ = [
    "CompressionConfig",
    "clear_registry",
    "register_layer",
    "set_layer_pattern_config",
]
