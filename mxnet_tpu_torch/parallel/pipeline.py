"""Pipeline parallelism over a 'pp' axis of ranks (SPMD GPipe).

Counterpart of ``mxnet_tpu/parallel/pipeline.py``. Every rank of the axis
runs the same program: stage p holds slice p of the stacked per-stage
parameters, and each tick every stage applies its block to the activation
it holds, then the activations hop one stage on (``lax.ppermute`` there,
:class:`~mxnet_tpu_torch.parallel.mesh.Shift` here) while a new microbatch
enters stage 0. Autograd differentiates through the shifts: the backward
is the reverse pipeline, with no hand-written schedule.

The ticks, masks and output slots are the JAX package's: ``n_micro + P -
1`` ticks, bubbles included. Autograd runs only the nodes that reach the
loss, so every rank keeps the same graph of shifts and outputs, as the JAX
program has: stage 0 takes its feed, the last stage its outputs,
and the aux of the bubble ticks is masked out, through ``torch.where`` on a
tensor condition, never by replacing or leaving out a tensor, so that on
every rank each shift's output reaches the loss and its backward runs (a
zero gradient where the value was masked): the rank on the other side is
never left waiting. A caller without aux uses the outputs on every stage,
as the JAX package's callers mask them.
The last tick's shift, which the JAX package computes and discards, is not
made.
"""

from __future__ import annotations

import torch

from .mesh import Shift, as_axis

__all__ = ["spmd_pipeline"]


def spmd_pipeline(block_fn, n_micro: int, axis=None, with_aux: bool = False):
    """Build a pipelined apply: ``fn(stage_params, x_micro) -> y_micro``.

    ``block_fn(stage_params, x)`` applies ONE stage to one microbatch
    ``[mb, ...] -> [mb, ...]`` (same shape). ``axis`` is the pp axis (a
    MeshAxis, a process group, or None for the world) where the JAX
    function takes an axis name. Call the returned function on every rank
    of the axis with ``stage_params`` this rank's block (each leaf keeps a
    leading stage dimension of 1) and ``x_micro`` ``[n_micro, mb, ...]``,
    the same on every rank.

    Returns ``y_micro`` ``[n_micro, mb, ...]``, valid on the LAST stage
    (zeros elsewhere). With ``with_aux=True``, ``block_fn`` returns ``(y,
    aux_scalar)`` and the result is ``(y_micro, aux_sum)``: this stage's aux
    over its ``n_micro`` real microbatches only (the bubble ticks run on
    garbage activations and are masked out); sum it over the axis for the
    total."""

    def run(stage_params, x_micro):
        ax = as_axis(axis)
        p, idx = ax.size, ax.index
        ticks = n_micro + p - 1
        device = x_micro.device
        first = torch.tensor(idx == 0, device=device)
        last = torch.tensor(idx == p - 1, device=device)
        cur = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                          device=device)
        outs = []
        aux_sum = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(ticks):
            # stage 0 ingests microbatch t (clamped; masked when t >= n_micro)
            cur = torch.where(first, x_micro[min(t, n_micro - 1)], cur)
            if with_aux:
                y, aux = block_fn(stage_params, cur)
                real = torch.tensor(holds_data(t, idx, n_micro),
                                    device=device)
                aux_sum = aux_sum + torch.where(real, aux, 0.0)
            else:
                y = block_fn(stage_params, cur)
            # the last stage emits microbatch t - (p - 1) once the pipe is
            # full; the others keep zeros in that slot
            if t >= p - 1:
                outs.append(torch.where(last, y, 0.0))
            if t != ticks - 1:   # the activations hop to the next stage
                (cur,) = Shift.apply(ax, y)
        outs = torch.stack(outs)
        return (outs, aux_sum) if with_aux else outs

    return run


def holds_data(tick: int, stage: int, n_micro: int) -> bool:
    """Whether ``stage`` holds a real microbatch at ``tick``: ticks
    ``[stage, stage + n_micro)``; the others are the bubble, whose aux is
    masked out."""
    return stage <= tick < stage + n_micro
