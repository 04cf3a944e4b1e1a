"""Data-parallel helpers over ``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py``. Where the JAX
package runs one program over a mesh with the batch sharded on its data
axis, here every rank runs the same step on its own rows, and the process
group (default: the world) is the data axis. :func:`shard_batch` and
:func:`replicate_params` place arrays on a mesh (``mesh.py``): each rank
keeps its own block, where the JAX package places a global array.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..comm.allreduce import _tree_map
from .mesh import P, Sharding, replicated

__all__ = ["shard_batch", "replicate_params", "allreduce_grads",
           "grad_accum", "make_data_parallel_step"]


def shard_batch(batch, mesh, axis="dp"):
    """This rank's rows of a tree of host arrays (or tensors), split over
    ``axis`` of ``mesh``, as tensors on the mesh's device."""
    sharding = Sharding(mesh, P(axis))
    return _tree_map(sharding.shard, batch)


def replicate_params(params, mesh):
    """A copy of a tree of arrays on the mesh's device, whole on every
    rank."""
    return _tree_map(replicated(mesh).shard, params)


def allreduce_grads(grads, group=None, average=True, compression=None,
                    axis_size=None):
    """Gradient allreduce over the ranks of ``group`` (reference:
    ReduceSumCPU + the dist_sync server accumulate). With
    ``compression=None`` a per-leaf sum; with a CompressionSpec or mode
    name one fused quantized bucket (``comm/allreduce.py``)."""
    from ..comm import compressed_allreduce

    return compressed_allreduce(grads, compression, group=group,
                                axis_size=axis_size, average=average)


def grad_accum(loss_fn, params, batch, n_micro):
    """Gradient accumulation over ``n_micro`` microbatches.

    ``batch`` is a dict of tensors whose leading dimension is divisible by
    ``n_micro``; ``loss_fn(params, microbatch)`` returns a scalar mean loss
    and ``params`` is a dict of tensors. Returns ``(mean_loss,
    mean_grads)``, the microbatch sums in order divided by ``n_micro``, as
    the JAX package's ``lax.scan``."""
    names = list(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss_acc = 0.0
    grads_acc = {k: torch.zeros_like(v) for k, v in params.items()}
    for i in range(n_micro):
        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                              + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()}
        loss = loss_fn(leaves, micro)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        loss_acc = loss_acc + loss.detach()
        grads_acc = {k: grads_acc[k] + g for k, g in zip(names, grads)}
    return (loss_acc / n_micro,
            {k: g / n_micro for k, g in grads_acc.items()})


def _value_and_grad(loss_fn, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_data_parallel_step(loss_fn, update_fn, group=None, n_micro=1,
                            compression=None, overlap=None):
    """Build a data-parallel train step over the ranks of ``group``.

    ``loss_fn(params, batch) -> scalar mean loss`` over this rank's rows;
    ``update_fn(params, opt_state, grads) -> (params, opt_state)``. Each
    rank computes its gradient (over ``n_micro`` microbatches with
    :func:`grad_accum`), the gradients are averaged over the ranks, and
    every rank applies the same update. The returned loss is the mean over
    the ranks, like ``pmean``.

    Returns ``step(params, opt_state, batch) -> (params, opt_state,
    loss)``. With a lossy ``compression`` (int8/twobit) the step carries
    this rank's error-feedback residual: ``step(params, opt_state, batch,
    comm_state) -> (params, opt_state, loss, comm_state)``, seeded with
    ``comm.init_error_feedback(params, spec, world_size)``. The quantize
    stages take the fused kernels when ``MXNET_TPU_COMM_KERNELS`` says so.

    ``overlap`` (True, a bucket byte cap or a ``comm.OverlapConfig``; with
    ``compression``) syncs the gradients bucket by bucket
    (``comm.overlap_allreduce``), and the comm state is then the
    per-bucket residual rows: seed it with ``comm.init_overlap_residuals(
    comm.plan_overlap({k: v.shape ...}, spec, world_size,
    max_bytes=...))``. Without a Symbol the plan orders the parameters by
    sorted name, reversed, which this step and the seeding call rebuild
    alike. ``params`` must then be a flat ``{name: tensor}`` dict.
    """
    from ..comm import (CompressionSpec, OverlapConfig, compressed_allreduce,
                        error_feedback_allreduce, overlap_allreduce,
                        plan_overlap)
    from ..comm.allreduce import all_reduce_sum

    spec = CompressionSpec.resolve(compression)
    overlap_cfg = OverlapConfig.resolve(overlap) if spec is not None \
        else None
    has_ef = spec is not None and spec.error_feedback
    if not dist.is_initialized():
        raise MXNetError("make_data_parallel_step needs a process group: "
                         "call torch.distributed.init_process_group first")
    ndev = dist.get_world_size(group)

    def local(params, batch):
        if n_micro > 1:
            return grad_accum(loss_fn, params, batch, n_micro)
        return _value_and_grad(loss_fn, params, batch)

    def mean_loss(loss):
        return all_reduce_sum(loss.float(), group) / ndev

    if overlap_cfg is not None:
        def reduce(grads, comm_state):
            if not isinstance(grads, dict):
                raise MXNetError(
                    "overlap= needs a flat {name: tensor} params dict (the "
                    "bucket schedule is keyed by parameter name)")
            plan = plan_overlap({k: tuple(g.shape) for k, g in grads.items()},
                                spec, ndev,
                                max_bytes=overlap_cfg.bucket_bytes)
            return overlap_allreduce(grads, comm_state, plan, group=group,
                                     average=True)
    elif has_ef:
        def reduce(grads, comm_state):
            return error_feedback_allreduce(grads, comm_state, spec,
                                            group=group, axis_size=ndev,
                                            average=True)
    else:
        def reduce(grads, comm_state):
            return compressed_allreduce(grads, spec, group=group,
                                        axis_size=ndev, average=True), None

    def step_with_state(params, opt_state, batch, comm_state):
        loss, grads = local(params, batch)
        grads, comm_state = reduce(grads, comm_state)
        with torch.no_grad():
            params, opt_state = update_fn(params, opt_state, grads)
        return params, opt_state, mean_loss(loss), comm_state

    if has_ef:
        return step_with_state

    def step(params, opt_state, batch):
        return step_with_state(params, opt_state, batch, None)[:3]

    return step
