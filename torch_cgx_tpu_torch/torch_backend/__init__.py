"""The DDP front end of the port:

    model = DistributedDataParallel(model)
    state = CGXState(None, compression_params={"bits": 4, "bucket_size": 512})
    model.register_comm_hook(state, cgx_hook)

over any ``torch.distributed`` group (NCCL, or gloo for several ranks on
one card), and at the end ``torch_backend.destroy_process_group()``, which
stops the groups' bucket workers before it destroys the group. Counterpart
of the JAX package's ``torch_backend`` without its c10d backend: the hook
runs the bucket allreduce (``backend.py``) on a worker thread of its own.
The per-layer setters are re-exported, as the JAX package does.
"""

from ..config import register_layer, set_quantization_bits, set_quantization_bucket_size
from .backend import destroy_process_group, host_fingerprint
from .hooks import CGXState, cgx_hook

__all__ = [
    "CGXState",
    "cgx_hook",
    "destroy_process_group",
    "host_fingerprint",
    "register_layer",
    "set_quantization_bits",
    "set_quantization_bucket_size",
]
