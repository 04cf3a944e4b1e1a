"""mxnet_tpu_torch: the port of mxnet_tpu to PyTorch and CUDA on an NVIDIA
H100.

It imports ``torch`` and never ``jax`` nor anything of ``mxnet_tpu``; it
keeps its own copies of what it needs. Slice 1 serves a Symbol graph through
:class:`Predictor`, with the int8 FullyConnected matmul in a hand-written
CUDA kernel (``csrc/int8_matmul.cu``). Slice 2 trains on one device through
:class:`FeedForward` (and :class:`Executor` for bound graphs), with the Adam
step in a hand-written multi-tensor CUDA kernel (``csrc/fused_adam.cu``).
Slice 3 is the transformer LM on one card, with the flash-attention kernels
(``csrc/flash_attention.cu``). Slice 4 trains data-parallel across
``torch.distributed`` ranks (``fit(kvstore="dist_sync", compression=...,
comm_kernels=...)``), with the gradient-compression kernels
(``csrc/comm_kernels.cu``). Slice 7 shards the transformer LM's step over a
``(dp, tp, sp)`` mesh of ranks (``parallel``), with ring flash attention
over sp. Entry points run on the card (``gpu(0)``) unless the caller passes
``ctx=cpu()``.
"""

from . import symbol, symbol as sym  # noqa: F401
from .base import MXNetError
from .context import Context, cpu, current_context, gpu
from . import ndarray, ndarray as nd  # noqa: F401
from . import random  # noqa: F401
from .executor import Executor, simple_bind
from .predictor import Predictor
from . import initializer, initializer as init  # noqa: F401
from . import io, lr_scheduler, metric, optimizer, callback  # noqa: F401
from .model import FeedForward, load_checkpoint, save_checkpoint
from . import models  # noqa: F401
from . import comm, kvstore, kvstore as kv, parallel  # noqa: F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "Predictor", "Executor", "simple_bind", "FeedForward",
           "save_checkpoint", "load_checkpoint", "symbol", "sym", "nd",
           "ndarray", "random", "init", "initializer", "io", "lr_scheduler",
           "metric", "optimizer", "callback", "models", "comm", "kvstore",
           "kv", "parallel"]
