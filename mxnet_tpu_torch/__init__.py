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
over sp. Slice 9 adds bf16 ``compute_dtype`` and remat to ``FeedForward``,
the zoo's remaining ops and models, ``Symbol.get_internals`` with
``Monitor``, the imperative ``NDArray`` and the f32 contractions' precision
setting (``set_matmul_precision``). Slice 10 adds the data path:
``engine``, ``filesystem``, ``recordio`` and ``io``'s iterators
(``ImageRecordIter`` with its own PNG codec and copies of PIL's resample
and affine transforms), the device feed of ``FeedForward.fit``, ``module``
(``Module``, ``BucketingModule``), ``bucketing`` and the LSTM LMs. Slice 11
adds sharded checkpoints with step-granular asynchronous resume
(``utils.checkpoint``, ``resilience.ckpt_async``), ``NumpyOp`` and
``visualization``, and ``utils.compile``: a training, eval or serving step
captured into a CUDA graph once per program key and replayed. Slice 12
captures remat steps too, and adds ``native``: the C++ data pipeline that
``ImageRecordIter`` takes for JPEG records, with a baseline JPEG codec of
its own (libjpeg's pixels and bytes). Slice 13 teaches that codec
progressive JPEG, and adds the overlapped per-bucket gradient exchange
(``comm.bucketing``, ``comm.overlap``, ``fit(overlap=...)``),
``KVStore.push_bucketed``, the ``dist_async`` parameter host
(``kvstore_async``), ``kvstore.create_group`` and ``kvstore_server``.
Slice 17 adds observability: ``telemetry`` (the metrics hub, step
timeline, MFU, JSONL/Prometheus exporters, flight recorder, memory
plans and live-array ledger, training health computed inside the
captured step, the device-time profiler, the run ledger and the CLI),
``analysis.lockwatch``, ``utils.memory`` and ``utils.profiler``, behind
``fit(telemetry=, health=, profile=)`` and ``predict(telemetry=,
profile=)``. Slice 19 adds the collective table (``comm.collective_table``
over a ``torch.profiler`` trace, beside the JAX package's HLO parsers),
``Monitor(track_comm=True)`` and ``resilience``'s chaos, retry, guards and
preemption, behind ``fit(guards=)``.
Entry points run on the card (``gpu(0)``) unless the caller passes
``ctx=cpu()``.
"""

from . import symbol, symbol as sym  # noqa: F401
from .base import MXNetError, get_matmul_precision, set_matmul_precision
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_devices)
from . import ndarray, ndarray as nd  # noqa: F401
from . import random  # noqa: F401
from .executor import Executor, simple_bind
from .predictor import Predictor
from . import initializer, initializer as init  # noqa: F401
from . import io, lr_scheduler, metric, optimizer, callback  # noqa: F401
from .model import FeedForward, load_checkpoint, save_checkpoint
from .monitor import Monitor
from . import models  # noqa: F401
from . import comm, kvstore, kvstore as kv, parallel  # noqa: F401
from . import engine, filesystem, recordio  # noqa: F401
from . import module, module as mod, bucketing  # noqa: F401
from .bucketing import BucketingFeedForward, BucketSentenceIter
from . import operator, resilience, utils, visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from .operator import NumpyOp
from .utils import checkpoint as _checkpoint, compile as _compile  # noqa: F401
from .utils import memory as _memory, profiler as _profiler  # noqa: F401
from . import analysis  # noqa: F401
from . import telemetry  # noqa: F401
# a launcher's server-role process (DMLC_ROLE=server) exits here, as the
# reference's does inside `import mxnet` (kvstore_server.py)
from . import kvstore_server  # noqa: F401,E402

__all__ = ["MXNetError", "set_matmul_precision", "get_matmul_precision",
           "Context", "cpu", "cpu_pinned", "gpu", "current_context",
           "num_devices", "Monitor",
           "Predictor", "Executor", "simple_bind", "FeedForward",
           "save_checkpoint", "load_checkpoint", "symbol", "sym", "nd",
           "ndarray", "random", "init", "initializer", "io", "lr_scheduler",
           "metric", "optimizer", "callback", "models", "comm", "kvstore",
           "kv", "parallel", "engine", "filesystem", "recordio", "module",
           "mod", "bucketing", "BucketingFeedForward", "BucketSentenceIter",
           "operator", "NumpyOp", "resilience", "utils",
           "visualization", "viz"]

# Background /metrics endpoint (Prometheus text): opt-in through
# MXNET_TPU_METRICS_PORT, as in the JAX package
telemetry.maybe_serve_http_from_env()
