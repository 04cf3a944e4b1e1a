"""The transformer LM's train step by sequence length on the card: the
port's counterpart of ``tools/bench_longctx.py``.

One full train step of ``models.transformer.TransformerLM`` (forward,
backward and the built-in SGD-momentum update at ``lr=1e-3``, f32
parameters, bf16 compute, attention through the flash kernels) at the JAX
tool's configuration: d_model 512, 8 heads, 4 layers, d_ff 2,048, vocab
8,192, batch 1, at sequences 2,048 to 32,768, each with and without
per-layer rematerialization (``remat=True``: each decoder layer under
``torch.utils.checkpoint``). The step is the model's own
``make_train_step``, captured into a CUDA graph on the card; its time is
the mean of ``--iters`` calls between CUDA events, each copying the
tokens in and replaying (the JAX tool slope-timed an in-device
``fori_loop``). Each record has the step's ms, tokens/s and the
allocator's peak bytes over the configuration. An out-of-memory error is
recorded as ``oom`` and the sweep goes on, the memory freed first.

    python -m mxnet_tpu_torch.tools.bench_longctx [--out LONGCTX_torch.json]

Writes ``--out`` (never the JAX tool's ``LONGCTX_r*.json``) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from . import _bench


def build_step(seq, remat, d_model=512, n_layers=4, vocab=8192,
               ctx=None):
    """The JAX tool's model and step at one sequence length: ``(model,
    step, params, moms)``, the parameters seeded on ``ctx``; ``step(params,
    moms, tokens, targets) -> (params, moms, loss)`` updates in place."""
    from ..models.transformer import TransformerLM, transformer_lm_config

    cfg = transformer_lm_config(vocab_size=vocab, d_model=d_model,
                                n_heads=d_model // 64, n_layers=n_layers,
                                d_ff=4 * d_model, max_len=seq, remat=remat)
    model = TransformerLM(cfg)
    params, moms = model.init_sharded(None, ctx=ctx)
    return model, model.make_train_step(None, lr=1e-3), params, moms


def bench_config(seq, remat, d_model=512, n_layers=4, vocab=8192, iters=4,
                 device=None):
    """-> dict record. An OOM is caught and recorded, not raised."""
    from ..context import Context

    device = torch.device(device)
    rec = {"seq": seq, "remat": bool(remat), "d_model": d_model,
           "n_layers": n_layers, "batch": 1}
    state = {}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    try:
        _, step, state["params"], state["moms"] = build_step(
            seq, remat, d_model, n_layers, vocab,
            ctx=Context("gpu", device.index or 0))
        gen = torch.Generator(device=device).manual_seed(0)
        tokens = torch.randint(0, vocab, (1, seq), generator=gen,
                               device=device)
        targets = torch.roll(tokens, -1, dims=1)

        def call():
            state["params"], state["moms"], state["loss"] = step(
                state["params"], state["moms"], tokens, targets)

        call()   # eager
        call()   # captured, replayed
        per_ms = _bench.replay_ms(call, iters, samples=1)
        loss = float(state["loss"])
        rec.update(step_ms=per_ms, tokens_per_sec=seq / per_ms * 1e3,
                   peak_bytes=torch.cuda.max_memory_allocated(device) - base,
                   loss=loss, oom=False)
    except torch.cuda.OutOfMemoryError as e:
        rec.update(oom=True, error=str(e)[:200])
    finally:
        state.clear()
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return rec


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="LONGCTX_torch.json")
    ap.add_argument("--seqs", default="2048,8192,16384,32768")
    ap.add_argument("--iters", type=int, default=4)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = _bench.card(what="bench_longctx")
    ident = _bench.card_identity(device)
    print(f"card={ident}", flush=True)
    records = []
    for seq in (int(s) for s in args.seqs.split(",")):
        for remat in (False, True):
            rec = bench_config(seq, remat, iters=args.iters, device=device)
            rec["card"] = ident
            print(json.dumps(rec), flush=True)
            records.append(rec)
    out = {"card": ident,
           "model": "TransformerLM d=512 L=4 flash b1 full train step",
           "timing": "captured step (make_train_step): --iters calls "
                     "between CUDA events, each copying the tokens in and "
                     "replaying",
           "iters": args.iters, "records": records}
    _bench.write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
