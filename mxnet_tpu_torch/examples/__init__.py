"""The port's counterparts of the JAX package's examples, one folder each
under ``examples/``: the launched ``distributed/`` and ``long_context/``,
and the single-process ``mnist/``, ``cifar10/``, ``imagenet/``, ``rnn/``,
``notebooks/``, ``numpy_ops/``, ``python_howto/``, ``adversary/`` and
``memcost/``. Each runs as ``python -m mxnet_tpu_torch.examples.<path>``
with the JAX script's command line; the launched ones (and
``imagenet/train_imagenet --kv-store dist_sync``) under the repo's
``tools/launch.py``, which starts the workers and sets the ``MXTPU_*``
variables the port's kvstores read:

    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_sync_mlp [--cpu]
    python -m mxnet_tpu_torch.examples.mnist.train_mnist [--cpu]

Each runs on the card unless ``--cpu`` is given; without CUDA and without
``--cpu`` it raises and names CUDA. ``import mxnet_tpu_torch`` imports
none of them.
"""

from __future__ import annotations

import argparse

import torch

from ..base import MXNetError
from ..context import Context, cpu, gpu
from ..kvstore import _local_rank


def example_context(use_cpu: bool) -> Context:
    """``cpu()`` when the caller asked for it, else this worker's card:
    ``gpu(LOCAL_RANK)``, else the launcher's rank (card ``i % n`` of the
    ``n`` cards, as ``parallel.mesh`` picks it). Raises ``MXNetError``
    naming CUDA where there is none: an example never goes on on the CPU
    by itself."""
    if use_cpu:
        return cpu()
    if not torch.cuda.is_available():
        raise MXNetError("this example runs on the card, and CUDA is not "
                         "available: pass --cpu to run it on the CPU")
    return gpu(_local_rank())


def example_contexts(use_cpu: bool, n: int) -> list:
    """The ``n`` contexts of ``--num-devices n`` (the JAX scripts' ``[mx.tpu(i)
    for i in range(n)]``): ``cpu(i)`` with ``--cpu``, else card ``i % cards``
    counted from this worker's card (:func:`example_context`; card 0 in one
    process), the rule ``parallel.mesh`` uses, so one card gives ``n``
    contexts on it. Raises as :func:`example_context` does where there is
    no CUDA."""
    if use_cpu:
        return [cpu(i) for i in range(n)]
    first = example_context(False).device_id
    cards = torch.cuda.device_count()
    return [gpu((first + i) % cards) for i in range(n)]


def cpu_parser(description: str) -> argparse.ArgumentParser:
    """The examples' command line: ``--cpu`` asks for the CPU."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: this worker's card)")
    return ap
