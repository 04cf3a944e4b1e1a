"""Long-context LM training over a sequence-parallel mesh, the port's
counterpart of ``examples/long_context/train_long_lm.py``.

The sequence axis is sharded over the mesh's ``sp`` dimension: every
attention layer runs RING attention (``parallel/sequence.py``) — each rank
holds seq/sp tokens and passes K/V blocks around the ring, so the sp-fold
longer context costs sp-fold more ranks, not sp²-fold more memory on one.
With ``--flash`` the rank-local block runs the online-softmax flash
kernels (``csrc/flash_attention.cu`` on the card, their plain versions on
the CPU).

Synthetic copy-task data (target t = token t-1) keeps the example
self-contained: the task is unlearnable without cross-position attention,
so convergence (about 4.7 at init to about 1, against 4.16 for a uniform
predictor) proves the ring path trains — the gradient flows backward
through the ring's shifts, not just the forward. The defaults converge in
about 600 steps with the model's plain SGD-momentum step.

The JAX script runs in one process over virtual devices; the port's mesh
is made of ranks (``parallel/mesh.py``), so this script runs under the
launcher with dp·sp workers, each joining the world from the launcher's
variables with gloo (ranks may share one card, which nccl refuses):

    # dp=2 x sp=2: four ranks, each holding seq/2 tokens of its rows
    python tools/launch.py -n 4 python -m \\
        mxnet_tpu_torch.examples.long_context.train_long_lm \\
        --dp 2 --sp 2 [--flash] [--cpu]

The JAX script's ``--cpu`` is on by default and keeps it on the host's
devices; here ``--cpu`` asks for the CPU, and without it every rank runs
on its card (``gpu(LOCAL_RANK)``, card ``i % n`` of ``n``).
"""

import numpy as np
import torch
import torch.distributed as dist

from ...kvstore import _maybe_init_distributed
from .. import cpu_parser, example_context


def parser():
    ap = cpu_parser(__doc__)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each decoder layer in the backward: "
                         "saved activations shrink to the layer "
                         "boundaries, letting --seq scale further")
    ap.add_argument("--flash", action="store_true",
                    help="flash formulation for the rank-local block")
    return ap


def train(argv=None, params=None):
    """The steps of :func:`main` without its assertion; returns the first
    loss, the last and every step's. ``params`` (the JAX package's global
    parameter layout, numpy) replaces the seeded initial weights."""
    args = parser().parse_args(argv)
    ctx = example_context(args.cpu)
    # gloo whatever the cards: ranks may share one, which nccl refuses
    _maybe_init_distributed("gloo")

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    transformer_lm_config)
    from mxnet_tpu_torch.parallel import data_sharding, make_mesh

    n = args.dp * args.sp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(
            f"need {n} ranks; run under python tools/launch.py -n {n}")
    mesh = make_mesh(dp=args.dp, sp=args.sp, devices=ctx)
    rank0 = mesh.rank == 0

    cfg = transformer_lm_config(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=4,
        n_layers=args.layers, max_len=args.seq, dtype=torch.float32,
        attn_impl="flash" if args.flash else "auto", remat=args.remat)
    model = TransformerLM(cfg)
    if params is None:
        params, moms = model.init_sharded(mesh, seed=0)
    else:
        params = convert.shard_transformer_params(params, mesh, model)
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
    step = model.make_train_step(mesh, lr=0.1)
    data = data_sharding(mesh, "sp")

    rng = np.random.RandomState(0)
    batch = 2 * args.dp

    def make_batch():
        toks = rng.randint(1, args.vocab, (batch, args.seq)).astype(np.int32)
        # copy task: target t = input t-1 (learnable by attention alone)
        tgt = np.concatenate([toks[:, :1], toks[:, :-1]], axis=1)
        return toks, tgt.astype(np.int32)

    losses = []
    for i in range(args.steps):
        toks, tgt = make_batch()
        params, moms, loss = step(params, moms, data.shard(toks),
                                  data.shard(tgt))
        losses.append(loss.detach())
        if i % 20 == 0 and rank0:
            # the JAX script's progress line: one read of the loss every
            # 20 steps, as there
            shown = float(loss)  # mxlint: disable=MX309
            print(f"step {i:4d}  loss {shown:.4f}  "
                  f"(seq {args.seq} over sp={args.sp}: "
                  f"{args.seq // args.sp} tokens/device)", flush=True)
    losses = [float(v) for v in losses]
    first, last = losses[0], losses[-1]
    if rank0:
        print(f"long-context LM: loss {first:.3f} -> {last:.3f} over "
              f"{args.steps} steps, ring attention sp={args.sp}")
    return first, last, losses


def main(argv=None, params=None):
    """Train and assert that the copy task was learned; returns what
    :func:`train` returns."""
    first, last, losses = train(argv, params)
    # uniform over the vocab is ln(64)=4.16: well below proves the
    # attention layers learned the one-position shift across shard
    # boundaries (the task is unlearnable without cross-position attention)
    assert last < 1.5, (first, last)
    return first, last, losses


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
