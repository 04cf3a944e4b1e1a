"""Run a function on several ``torch.distributed`` ranks of CPU processes,
for the port's data-parallel tests. Not a test module: the ranks import it,
and it imports torch, numpy and ``mxnet_tpu_torch`` only, never JAX.

``run_ranks(body, world, tmp_path, *args)`` starts ``world`` processes with
the ``spawn`` method, joins them into a gloo group through a ``file://``
rendezvous in ``tmp_path``, calls ``body(rank, world, *args)`` in each and
returns the results (numpy values) in rank order. A rank that fails raises
here with its traceback; a run that outlasts ``timeout`` seconds kills every
rank and raises, so no hang reaches the suite's time limit.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

import numpy as np

RANK_TIMEOUT_S = 120.0


def _rank_main(body, rank, world, init_method, join, args, queue):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if join:
            dist.init_process_group(
                "gloo", init_method=init_method, rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        else:
            # the port joins the world itself, from tools/launch.py's variables
            os.environ.update(MXTPU_COORDINATOR=init_method,
                              MXTPU_NUM_WORKERS=str(world),
                              MXTPU_WORKER_RANK=str(rank))
        queue.put((rank, True, body(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(body, world, tmp_path, *args, join=True,
              timeout=RANK_TIMEOUT_S):
    """``[body(rank, world, *args) for rank in range(world)]``, each in a
    rank process of its own. With ``join=False`` the ranks get the
    ``MXTPU_*`` variables instead of a joined group."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"file://{os.path.join(str(tmp_path), 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(body, rank, world, init_method, join, args,
                               queue))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        # drain the queue before joining (a writer blocks on a full pipe)
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {body.__name__} did not "
                                   f"finish in {timeout} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {body.__name__} "
                                       "died without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {body.__name__} "
                                   f"failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.detach().cpu().numpy().copy()


# -- rank bodies ---------------------------------------------------------------

def exchange(rank, world, cases):
    """Each case through ``error_feedback_allreduce`` (with a residual) or
    ``compressed_allreduce``: ``{"mode", "kernels", "average", "grads":
    {name: (world, ...) array}, "resid": (world, Lp) array or None}``; this
    rank feeds row ``rank`` of each."""
    import torch

    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.comm import allreduce
    from mxnet_tpu_torch.convert import residual_rows_from_numpy

    wire, sent = allreduce._wire, []

    def counting_wire(op, out, inp, group):
        sent.append((op, inp.numel() * inp.element_size()))
        return wire(op, out, inp, group)

    allreduce._wire = counting_wire
    out = []
    for case in cases:
        sent.clear()
        spec = comm.CompressionSpec(case["mode"], threshold=case["threshold"],
                                    chunk=case["chunk"])
        tree = {k: torch.from_numpy(v[rank].copy())
                for k, v in case["grads"].items()}
        if case["resid"] is not None:
            resid = residual_rows_from_numpy(case["resid"], rank)
            reduced, new = comm.error_feedback_allreduce(
                tree, resid, spec, average=case["average"],
                kernels=case["kernels"])
        else:
            reduced = comm.compressed_allreduce(
                tree, spec if spec.mode != "none" else None,
                average=case["average"], kernels=case["kernels"])
            new = None
        out.append({"out": _numpy(reduced), "resid": _numpy(new),
                    "wire": list(sent)})
    return out


def kvstore_closed_form(rank, world):
    """examples/distributed/dist_sync_kvstore.py through the port: the
    store joins the world from the MXTPU_* variables; every rank pushes
    ``rank + 1`` and pulls the BSP sum."""
    import torch

    import mxnet_tpu_torch as mt

    kv = mt.kv.create("dist_sync", ctx=mt.cpu())
    shape, keys, big_key, big_shape = (4, 4), [3, 5, 7], 99, (1200,)
    kv.init(keys, [torch.ones(shape)] * len(keys))
    kv.init(big_key, torch.ones(big_shape))
    kv.push(keys, [[torch.ones(shape) * (kv.rank + 1)]] * len(keys))
    kv.push(big_key, [torch.ones(big_shape) * (kv.rank + 1)])
    outs = [torch.empty(shape) for _ in keys]
    kv.pull(keys, out=outs)
    big = torch.empty(big_shape)
    kv.pull(big_key, out=big)
    kv.barrier()
    return {"rank": kv.rank, "num_workers": kv.num_workers,
            "keys": [o.numpy() for o in outs], "big": big.numpy()}


def data_parallel_steps(rank, world, w0, X, Y, compression, steps, n_micro,
                        overlap=None):
    """``steps`` steps of ``make_data_parallel_step`` on a linear
    least-squares model with SGD, this rank on its share of the rows
    (bucket by bucket with ``overlap``)."""
    import torch

    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.parallel import make_data_parallel_step

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return ((pred - batch["y"]) ** 2).mean()

    def update_fn(p, state, grads):
        return {k: p[k] - 0.1 * grads[k] for k in p}, state

    step = make_data_parallel_step(loss_fn, update_fn, n_micro=n_micro,
                                   compression=compression, overlap=overlap)
    params = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    per = X.shape[0] // world
    batch = {"x": torch.from_numpy(X[rank * per:(rank + 1) * per].copy()),
             "y": torch.from_numpy(Y[rank * per:(rank + 1) * per].copy())}
    spec = comm.CompressionSpec.resolve(compression)
    cstate = comm.init_error_feedback(params, spec, world)
    if overlap is not None:
        cstate = comm.init_overlap_residuals(comm.plan_overlap(
            {k: tuple(v.shape) for k, v in params.items()}, spec, world,
            max_bytes=overlap))
    losses, history = [], []
    for _ in range(steps):
        if cstate is not None:
            params, _, loss, cstate = step(params, None, batch, cstate)
        else:
            params, _, loss = step(params, None, batch)
        losses.append(float(loss))
        history.append(_numpy(params))
    return {"losses": losses, "params": history}


def small_net(mt):
    """FC(32) -> BatchNorm -> relu -> FC(10) -> SoftmaxOutput, in either
    package's symbol API (``mt`` is the package)."""
    s = mt.symbol
    h = s.FullyConnected(s.Variable("data"), num_hidden=32, name="fc1")
    h = s.BatchNorm(h, name="bn1")
    h = s.Activation(h, act_type="relu", name="relu1")
    h = s.FullyConnected(h, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def fit_dist_sync(rank, world, args, aux, X, Y, epochs, fit_kw, model_kw):
    """``FeedForward(small_net, ctx=cpu()).fit(kvstore="dist_sync", ...)``
    on this rank's share of each global batch (the rows a dp mesh gives its
    device ``rank``), without shuffling. Returns each epoch's parameters and
    auxiliary states, each step's cross-entropy sum over this rank's rows,
    the comm stats and the residual."""
    import mxnet_tpu_torch as mt

    batch = X.shape[0]
    per = batch // world
    rows = np.concatenate([np.arange(b + rank * per, b + (rank + 1) * per)
                           for b in range(0, X.shape[0], batch)])
    epochs_seen, sums = [], []

    def on_epoch(epoch, symbol, arg_params, aux_params):
        epochs_seen.append((_numpy(arg_params), _numpy(aux_params)))

    mt.comm.reset_comm_stats()
    model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=epochs,
                           arg_params=args, aux_params=aux, **model_kw)
    model.fit(mt.io.NDArrayIter(X[rows], Y[rows], batch_size=per,
                                shuffle=False),
              kvstore="dist_sync", eval_metric="ce",
              epoch_end_callback=on_epoch,
              batch_end_callback=lambda p: sums.append(
                  p.eval_metric.sum_metric), **fit_kw)
    sync = model._train_state.grad_sync
    plan = sync.plan
    return {"epochs": epochs_seen, "ce_sums": sums,
            "stats": mt.comm.comm_stats(),
            "residual": _numpy(sync.residual),
            "residuals": _numpy(sync.residuals()),
            "plan": None if plan is None else {
                "layout_key": plan.layout_key(), "buckets": plan.buckets},
            "rescale_grad": model._optimizer_obj.rescale_grad}


def overlap_cases(rank, world, cases, device="cpu"):
    """Each case through ``overlap_allreduce`` after backward and through
    the hook schedule (``OverlapSchedule``) during it, on the same
    gradients: ``{"mode", "kernels", "cap", "grads": {name: (world, ...)},
    "resid": {bucket: (world, Lp_b)} or None, "unused": name or None}``.
    The schedule's backward is of ``sum(p * g)``, so each parameter's
    gradient is its row of ``grads`` added into the residual; ``unused``
    names a parameter the loss leaves out (its bucket starts after
    backward). With ``device="cuda"`` the schedule runs on the card (side
    stream, events) and ``overlap_allreduce`` on CPU copies."""
    import torch

    from mxnet_tpu_torch import comm

    dev = torch.device(device)
    out = []
    for case in cases:
        spec = comm.CompressionSpec(case["mode"], chunk=case["chunk"])
        grads = {k: torch.from_numpy(v[rank].copy())
                 for k, v in case["grads"].items()}
        plan = comm.plan_overlap({k: tuple(v.shape) for k, v in grads.items()},
                                 spec, world, max_bytes=case["cap"])
        resid = None if case["resid"] is None else {
            b: torch.from_numpy(v[rank:rank + 1].copy())
            for b, v in case["resid"].items()}
        fed = dict(grads)
        if case["unused"] is not None:  # no gradient reaches it
            fed[case["unused"]] = torch.zeros_like(grads[case["unused"]])
        after, new = comm.overlap_allreduce(fed, resid, plan,
                                            kernels=case["kernels"])
        sched = comm.OverlapSchedule(plan, dev, kernels=case["kernels"])
        if resid is not None:
            for i, b in enumerate(plan.buckets):
                sched.bucket_slice(i).copy_(resid[b["name"]][0])
        params = {k: torch.zeros(v.shape, device=dev, requires_grad=True)
                  for k, v in grads.items()}
        sched.attach(params)
        loss = sum((params[k] * grads[k].to(dev)).sum() for k in sorted(params)
                   if k != case["unused"])
        torch.autograd.backward(loss, inputs=list(params.values()))
        sched.finish_backward()
        during = sched.wait()
        if device != "cpu":
            torch.cuda.synchronize()
        sched.close()
        # the unused parameter's gradient is zero (or its residual only)
        out.append({"after": _numpy(after), "during": _numpy(during),
                    "resid_after": _numpy(new),
                    "resid_during": _numpy(sched.residuals()),
                    "plan": plan.layout_key()})
    return out


def dist_async_semantics(rank, world, port):
    """examples/distributed/dist_async_kvstore.py through the port: rank 0
    pushes three times and pulls while the others wait at a barrier (BSP
    would deadlock), then every worker pushes once."""
    import os

    import torch

    import mxnet_tpu_torch as mt

    os.environ["MXTPU_ASYNC_PORT"] = str(port)
    kv = mt.kv.create("dist_async")
    assert kv.type == "dist_async"
    rank, nworker = kv.rank, kv.num_workers
    shape, key = (4,), 11
    kv.init(key, torch.zeros(shape))
    kv.set_optimizer(mt.optimizer.create("test"))  # w += g on the host
    seen = []
    out = torch.empty(shape)
    if rank == 0:
        for _ in range(3):
            kv.push(key, [torch.ones(shape)])
        kv.pull(key, out=out)
        seen.append(out.numpy().copy())
    kv.barrier()
    kv.pull(key, out=out)
    seen.append(out.numpy().copy())
    kv.barrier()
    kv.push(key, [torch.ones(shape)])
    kv.barrier()
    kv.pull(key, out=out)
    seen.append(out.numpy().copy())
    kv.barrier()
    stats = kv.stats()
    kv.barrier()
    kv.close()
    return {"rank": rank, "num_workers": nworker, "seen": seen,
            "stats": stats}


def dist_async_staleness(rank, world, port, batches, skew):
    """examples/distributed/dist_async_staleness.py through the port:
    logistic regression, each worker ``rank * skew`` seconds slower a
    batch; the host applies every push on arrival."""
    import os
    import time

    import torch

    import mxnet_tpu_torch as mt

    os.environ["MXTPU_ASYNC_PORT"] = str(port)
    kv = mt.kv.create("dist_async")
    rng = np.random.RandomState(7)
    w_true = rng.randn(8).astype(np.float32)
    X = rng.randn(1024, 8).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
    kv.init(0, torch.zeros(8))
    rng = np.random.RandomState(100 + rank)
    done = 0
    for _ in range(batches):
        idx = rng.randint(0, len(X), size=64)
        xb, yb = X[idx], y[idx]
        w = kv.pull_many([0])[0]
        p = 1.0 / (1.0 + np.exp(-(xb @ w)))
        kv.push_pull({0: (xb.T @ (p - yb) / 64).astype(np.float32)})
        done += 1
        time.sleep(rank * skew)
    kv.barrier()
    out = {"done": done}
    if rank == 0:
        out["stats"] = kv.stats()
        w = kv.pull_many([0])[0]
        p = 1.0 / (1.0 + np.exp(-(X @ w)))
        out["acc"] = float(np.mean((p > 0.5) == (y > 0.5)))
    kv.barrier()
    kv.close()
    return out


def parallel_cases(rank, world, data):
    """The cases of tests/test_torch_parallel.py on one rank of 8: meshes,
    tensor-parallel products with their gradients over a tp axis of 8, the
    dense and flash rings over an sp axis of 8, and ring self-attention on
    a dp 2 x tp 2 x sp 2 mesh. Returns the meshes' shapes and this rank's
    coordinates, and the gathered (global) results."""
    import torch

    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel.mesh import P, Sharding

    def coords(mesh):
        return {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}

    out = {}
    mesh = par.make_mesh(dp=2, tp=2, sp=2, devices=cpu())
    out["mesh"] = coords(mesh)
    out["auto_mesh"] = coords(par.auto_mesh(tp=4, devices=cpu()))
    try:
        par.make_mesh(dp=3, tp=2, devices=cpu())
    except ValueError as e:
        out["mesh_error"] = str(e)

    # a batch split over dp, parameters whole on every rank
    out["shard_batch"] = _numpy(par.shard_batch(
        {"x": data["batch"], "y": data["batch"][:, 0]}, mesh))
    out["replicate_params"] = _numpy(par.replicate_params(
        {"w": data["batch"]}, mesh))

    # column then row parallel over tp = 8, a process group as the axis
    m_tp = par.make_mesh(tp=8, devices=cpu())
    group = m_tp.axis("tp").group
    cols, rows = Sharding(m_tp, P(None, "tp")), Sharding(m_tp, P("tp", None))
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    w1 = cols.shard(data["w1"]).requires_grad_(True)
    w2 = rows.shard(data["w2"]).requires_grad_(True)
    y = par.row_parallel(par.column_parallel(x, w1, group=group), w2,
                         group=group)
    dx, dw1, dw2 = torch.autograd.grad((y * torch.from_numpy(data["r"]))
                                       .sum(), (x, w1, w2))
    out["colrow"] = {"y": _numpy(y), "dx": _numpy(dx),
                     "dw1": _numpy(cols.gather(dw1)),
                     "dw2": _numpy(rows.gather(dw2))}

    # the rings over sp = 8
    m_sp = par.make_mesh(sp=8, devices=cpu())
    seq = Sharding(m_sp, P(None, None, "sp", None))
    sp = m_sp.axis("sp")
    q, k, v = (seq.shard(t) for t in data["ring"])
    for causal in (False, True):
        out[f"ring_{causal}"] = _numpy(seq.gather(
            par.ring_attention(q, k, v, sp, causal=causal)))
    q, k, v = (seq.shard(t).requires_grad_(True) for t in data["flash"])
    w = seq.shard(data["flash_w"])
    for causal in (False, True):
        o = par.ring_flash_attention(q, k, v, sp, causal=causal)
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out[f"ring_flash_{causal}"] = [_numpy(seq.gather(t))
                                       for t in (o, *grads)]

    # ring self-attention on this rank's P("dp", "tp", "sp", None) block
    block = Sharding(mesh, P("dp", "tp", "sp", None))
    for flash in (False, True):
        q, k, v = (block.shard(t) for t in data[f"self_{flash}"])
        out[f"self_{flash}"] = _numpy(block.gather(par.ring_self_attention(
            mesh, q, k, v, causal=True, use_flash=flash)))
    return out


def sharded_transformer(rank, world, config, params, tokens, targets, cases):
    """One train step of the transformer LM on a dp 2 x tp 2 x sp 2 mesh
    for each case ``(name, attn_impl, optimizer, remat)`` from the global
    ``params`` (numpy, the JAX package's layout), this rank on its blocks.
    Returns, for each case, the loss, the gathered parameters (and Adam
    state) and this rank's blocks; and the shard-then-gather round trip."""
    import torch

    from mxnet_tpu_torch import convert, cpu
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
    from mxnet_tpu_torch.parallel import data_sharding, make_mesh

    mesh = make_mesh(dp=2, tp=2, sp=2, devices=cpu())
    data = data_sharding(mesh, "sp")
    tok, tgt = data.shard(tokens), data.shard(targets)
    out = {"coords": dict(mesh.coords)}
    for name, attn_impl, opt_name, remat in cases:
        model = TransformerLM(transformer_lm_config(
            **config, dtype=torch.float32, attn_impl=attn_impl, remat=remat))
        local = convert.shard_transformer_params(params, mesh, model)
        if opt_name == "adam":
            opt = topt.Adam(learning_rate=1e-2, epsilon=1e-3, fused=True)
            state = opt.init_state_tree(local)
            step = model.make_train_step(mesh, optimizer=opt)
        else:
            state = {k: torch.zeros_like(v) for k, v in local.items()}
            step = model.make_train_step(mesh, lr=0.1)
        local, state, loss = step(local, state, tok, tgt)
        res = {"loss": float(loss), "local": _numpy(local),
               "params": convert.gather_transformer_params(local, mesh,
                                                           model)}
        if opt_name == "adam":
            res["state"] = convert.gather_optimizer_state(state, mesh, model)
            res["state_roundtrip"] = convert.gather_optimizer_state(
                convert.shard_optimizer_state(res["state"], mesh, model),
                mesh, model)
        out[name] = res
    model = TransformerLM(transformer_lm_config(**config,
                                                dtype=torch.float32))
    out["roundtrip"] = convert.gather_transformer_params(
        convert.shard_transformer_params(params, mesh, model), mesh, model)
    return out


def pipeline_moe(rank, world, data):
    """The cases of tests/test_torch_pipeline_moe.py on one rank of 8:
    ``all_to_all`` over an ep axis of 4, the pipeline over a pp axis of 4
    (with and without aux), ``moe_ffn`` over ep axes of 2 and 4 at two
    capacity factors, and 3 steps of the MoE pipeline LM on a dp 2 x pp 2
    x ep 2 mesh. Each dp line of a mesh computes the whole case; results
    are gathered into global arrays (the LM's also kept as this rank's
    blocks)."""
    import torch

    from mxnet_tpu_torch import convert, cpu
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import MoEPipelineLM, moe_pipeline_config
    from mxnet_tpu_torch.parallel import expert
    from mxnet_tpu_torch.parallel.mesh import (P, Sharding, all_gather,
                                               all_reduce_sum, all_to_all)

    def t(x):
        return torch.from_numpy(np.array(x))

    out = {}
    # all_to_all over ep = 4, and its gradient
    mesh = par.make_mesh(dp=2, ep=4, devices=cpu())
    rows = Sharding(mesh, P("ep"))
    for split, concat in data["a2a_cases"]:
        x = rows.shard(data["a2a_x"]).requires_grad_(True)
        y = all_to_all(x, mesh.axis("ep"), split, concat)
        (g,) = torch.autograd.grad(y, x, rows.shard(data["a2a_r"][
            (split, concat)]))
        out[f"a2a_{split}{concat}"] = [_numpy(rows.gather(v))
                                       for v in (y.detach(), g)]

    # the pipeline over pp = 4: outputs, gradients of the stage weights and
    # of x (summed over the stages), the aux summed over the stages
    mesh = par.make_mesh(dp=2, pp=4, devices=cpu())
    pp = mesh.axis("pp")
    stages = Sharding(mesh, P("pp"))

    def block(w, m):
        return torch.tanh(m @ w[0])

    def block_aux(w, m):
        y = block(w, m)
        return y, (y * y).mean()

    for with_aux in (False, True):
        w = stages.shard(data["pipe_w"]).requires_grad_(True)
        x = t(data["pipe_x"]).requires_grad_(True)
        pipe = par.spmd_pipeline(block_aux if with_aux else block,
                                 data["n_micro"], pp, with_aux=with_aux)
        res = pipe(w, x)
        y, aux = res if with_aux else (res, torch.zeros(()))
        loss = (y * t(data["pipe_r"])).sum() + aux
        dw, dx = torch.autograd.grad(loss, (w, x))
        out[f"pipe_{with_aux}"] = {
            "y": _numpy(all_reduce_sum(y.detach(), pp)),
            "dw": _numpy(stages.gather(dw)),
            "dx": _numpy(all_reduce_sum(dx, pp)),
            "aux": _numpy(all_reduce_sum(aux.detach(), pp))}

    # moe_ffn: this rank's tokens and experts of an ep axis; output, aux and
    # routing per rank (gathered), the gradients of x, gate, w1 and w2
    for ep in (2, 4):
        mesh = par.make_mesh(dp=world // ep, ep=ep, devices=cpu())
        axis = mesh.axis("ep")
        tok, exp = Sharding(mesh, P("ep")), Sharding(mesh, P("ep"))
        m = data["moe"]
        for cf in (2.0, 0.5):
            x = tok.shard(m["x"]).requires_grad_(True)
            gate = t(m["gate"]).requires_grad_(True)
            w1 = exp.shard(m["w1"]).requires_grad_(True)
            w2 = exp.shard(m["w2"]).requires_grad_(True)
            y, aux = par.moe_ffn(x, gate, w1, w2, axis, capacity_factor=cf,
                                 return_aux=True)
            loss = (y * tok.shard(m["r"])).sum() + aux
            dx, dg, d1, d2 = torch.autograd.grad(loss, (x, gate, w1, w2))
            cap = expert.expert_capacity(cf, x.shape[0], m["gate"].shape[1])
            _, _, onehot, dispatch = expert.route(x.detach(), gate.detach(),
                                                  cap)
            kept = dispatch.sum((1, 2)) > 0
            slot = torch.where(kept, dispatch.sum(1).argmax(-1), -1)
            out[f"moe_{ep}_{cf}"] = {
                "y": _numpy(tok.gather(y.detach())),
                "aux": _numpy(all_gather(aux.detach(), axis)),
                "expert": _numpy(tok.gather(onehot.argmax(-1))),
                "slot": _numpy(tok.gather(slot)),
                "dx": _numpy(tok.gather(dx)),
                "dgate": _numpy(all_reduce_sum(dg, axis)),
                "dw1": _numpy(exp.gather(d1)), "dw2": _numpy(exp.gather(d2))}

    # the MoE pipeline LM: 3 steps on dp 2 x pp 2 x ep 2
    mesh = par.make_mesh(dp=2, pp=2, ep=2, devices=cpu())
    model = MoEPipelineLM(moe_pipeline_config(**data["lm_config"]))
    batch = Sharding(mesh, P(("dp", "ep"), None))
    tokens, targets = (batch.shard(v) for v in data["lm_batch"])
    params = convert.shard_transformer_params(data["lm_params"], mesh, model)
    roundtrip = convert.gather_transformer_params(params, mesh, model)
    moms = {k: torch.zeros_like(v) for k, v in params.items()}
    step = model.make_train_step(mesh, lr=0.1)
    losses = []
    for _ in range(data["lm_steps"]):
        params, moms, loss = step(params, moms, tokens, targets)
        losses.append(float(loss))
    out["lm"] = {"coords": dict(mesh.coords), "losses": losses,
                 "local": _numpy(params), "roundtrip": roundtrip,
                 "params": convert.gather_transformer_params(params, mesh,
                                                             model),
                 "moms": convert.gather_transformer_params(moms, mesh, model),
                 "local_batch": _numpy(tokens),
                 "batch": _numpy(batch.gather(tokens))}
    return out



def kvstore_bucketed(rank, world, values, bf16):
    """``push_bucketed`` of ``values[rank]`` (``{key: array}``) on a
    dist_sync store joined from the MXTPU_* variables, with a bf16 wire
    when ``bf16``; returns what each key pulls."""
    import torch

    import mxnet_tpu_torch as mt

    kv = mt.kv.create("dist_sync", ctx=mt.cpu())
    if bf16:
        kv.set_gradient_compression("bf16")
    mine = values[rank]
    kv.init(list(mine), [torch.zeros(v.shape) for v in mine.values()])
    kv.push_bucketed({k: torch.from_numpy(v.copy()) for k, v in mine.items()})
    out = {k: torch.empty(v.shape) for k, v in mine.items()}
    kv.pull(list(out), out=list(out.values()))
    kv.barrier()
    return {k: v.numpy() for k, v in out.items()}


def telemetry_fit(rank, world, X, Y, pattern, steps):
    """``fit(kvstore="dist_sync", telemetry=<path>)`` of the small net on
    this rank's rows, ``steps`` steps of one epoch, every hub event
    streamed to ``pattern.format(rank)``. Returns the path."""
    import mxnet_tpu_torch as mt

    per = X.shape[0] // (world * steps)
    rows = np.concatenate([np.arange(s * world * per + rank * per,
                                     s * world * per + (rank + 1) * per)
                           for s in range(steps)])
    model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    model.fit(mt.io.NDArrayIter(X[rows], Y[rows], batch_size=per,
                                shuffle=False),
              kvstore="dist_sync",
              telemetry=mt.telemetry.TelemetryConfig(
                  jsonl=pattern.format(rank)))
    return pattern.format(rank)


def comm_table_cases(rank, world, cases):
    """Each case's exchange under ``torch.profiler``: ``{"mode", "grads":
    {name: (world, ...) array}, "cap": overlap bucket bytes or None,
    "feedback": bool}``; this rank feeds row ``rank``. Returns, a case,
    the profiled collective table and rows (from the profiler object and
    from its exported chrome trace) and the quantize passes at the flat
    size."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import comm

    out = []
    for case in cases:
        spec = comm.CompressionSpec.resolve(case["mode"])
        grads = {k: torch.from_numpy(v[rank].copy())
                 for k, v in case["grads"].items()}
        flat = comm.flat_size(grads)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            if case["cap"] is not None:
                plan = comm.plan_overlap(
                    {k: tuple(v.shape) for k, v in grads.items()}, spec,
                    world, max_bytes=case["cap"])
                resid = comm.init_overlap_residuals(plan) \
                    if case["feedback"] else None
                comm.overlap_allreduce(grads, resid, plan)
            elif case["feedback"]:
                resid = comm.init_error_feedback(grads, spec, world)
                comm.error_feedback_allreduce(grads, resid, spec,
                                              axis_size=world)
            else:
                comm.compressed_allreduce(grads, spec, axis_size=world)
        path = os.path.join(tempfile.mkdtemp(), "trace.json")
        prof.export_chrome_trace(path)
        out.append({"table": comm.collective_table(prof),
                    "rows": comm.collective_rows(prof),
                    "trace_table": comm.collective_table(path),
                    "passes": comm.quantize_pass_count(prof, flat),
                    "trace_passes": comm.quantize_pass_count(path, flat)})
    return out


def fit_guarded(rank, world, args, aux, X, Y, batch, poison_rank, fit_kw):
    """``fit_dist_sync``'s fit, global batches of ``batch`` rows, with
    ``guards=True`` and the batch of rank ``poison_rank``'s second step
    poisoned (the ``step.nan`` chaos site, armed on that rank only).
    Returns the final parameters, ``guard_stats`` and the chaos sites
    that fired."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.resilience import chaos_scope

    per = batch // world
    rows = np.concatenate([np.arange(b + rank * per, b + (rank + 1) * per)
                           for b in range(0, X.shape[0], batch)])
    model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=1,
                           arg_params=args, aux_params=aux,
                           learning_rate=0.1, momentum=0.9)
    rules = {"step.nan": {1}} if rank == poison_rank else {}
    with chaos_scope(seed=0, rules=rules) as cz:
        model.fit(mt.io.NDArrayIter(X[rows], Y[rows], batch_size=per,
                                    shuffle=False),
                  kvstore="dist_sync", guards=True, **fit_kw)
    return {"params": _numpy(model.arg_params),
            "aux": _numpy(model.aux_params),
            "guard_stats": dict(model.guard_stats), "fired": dict(cz.fired)}


def shard_audit_fit(rank, world, args, aux, X, Y, batch, cases):
    """``fit_dist_sync``'s fit, global batches of ``batch`` rows, once a
    case: ``{"mode", "overlap", "audit", "plan_mode"}``. ``audit`` passes
    ``shard_audit=True``; ``plan_mode`` seeds a wrong plan (the shard
    audit holds the step to that mode's plan). Returns, a case, the
    final parameters, the audit's reports (findings, matched rows, notes,
    the aux elements reconciled) or the error it raised, with the
    parameters the trainer held then."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    per = batch // world
    rows = np.concatenate([np.arange(b + rank * per, b + (rank + 1) * per)
                           for b in range(0, X.shape[0], batch)])
    real_plan = mt.model.FeedForward.__dict__["_shard_audit_plan"]
    out = []
    for case in cases:
        if case.get("plan_mode"):
            def wrong(sync, mode=case["plan_mode"]):
                plan = mt.comm.allreduce_plan(sync.size, sync.num_workers,
                                              mode)
                return plan, mt.comm.CompressionSpec.resolve(mode)

            mt.model.FeedForward._shard_audit_plan = staticmethod(wrong)
        model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=1,
                               arg_params=args, aux_params=aux,
                               learning_rate=0.1, momentum=0.9)
        res = {"error": None}
        try:
            model.fit(mt.io.NDArrayIter(X[rows], Y[rows], batch_size=per,
                                        shuffle=False),
                      kvstore="dist_sync", compression=case["mode"],
                      overlap=case["overlap"], comm_kernels=True,
                      shard_audit=case["audit"])
            res["params"] = _numpy(model.arg_params)
        except MXNetError as e:
            res["error"] = str(e)
            res["params"] = _numpy(model._train_state.params)
        finally:
            mt.model.FeedForward._shard_audit_plan = real_plan
        res["reports"] = [{
            "findings": [(f.rule.id, f.node) for f in rep.findings],
            "matched": rep.reconciliation.get("matched"),
            "stat_rows": rep.reconciliation.get("stat_rows"),
            "notes": rep.reconciliation.get("notes"),
            "aux_elements": rep.reconciliation.get("aux_elements"),
            "audit_notes": list(rep.notes)}
            for rep in model.shard_audit_reports]
        out.append(res)
    return out
