#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

from the root of a checkout. It needs one card, builds every CUDA kernel of
the port from ``mxnet_tpu_torch/csrc`` (one nvcc per source, all started
together), and then:

1. card: prints the card's name and power limit as nvidia-smi reports them,
   and the kernels' build time;
2. kernels: holds int8_matmul against its plain PyTorch version on the card,
   bitwise, at the shapes the serving path gives it and a few more, and times
   it (CUDA events, L2 flushed, median) beside its bound, its plain version
   and the library calls that compute the same contraction;
3. slice (serving): serves a full-width ResNet-50 (batch 32, 3x224x224, 1000
   classes, seeded random weights) through
   ``Predictor(ctx=gpu(0), quantize="int8")`` and with ``quantize=None``,
   checks the outputs, that every int8 request launched the kernel, and the
   card's results against the CPU's on two images, and prints request
   latency and images per second;
4. fused_adam: holds the multi-tensor Adam kernel bitwise against its plain
   version and against the per-leaf ``Optimizer.apply``, over 3 steps, on
   ResNet-50's 161 parameters and on an odd set, for Adam (rescale, clip,
   L2 decay) and AdamW (decay filter), and times it beside its bound, its
   plain version and ``torch.optim.Adam(fused=True)``;
5. train (training slice): trains the full-width ResNet-50 (batch 32) for 8
   steps through ``FeedForward(ctx=gpu(0), optimizer="adam", fused=True)``,
   checks that every step launched the kernel once, that the loss and the
   parameters are finite and moved, that the loss of the batch it overfits
   fell, and the card's gradients at batch 4 against the CPU's and against a
   float64 CPU run, and prints the step time, images per second and one
   step's forward / backward / update split;
6. flash: holds the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions on the card, row by row, and lse at f32's
   precision, at the transformer LM's shape (q, k, v views of one packed
   qkv, 8x8x2048x64 bf16, causal), at a non-causal shape, at a ragged f32
   one and at the bf16 Hopper kernels' edges (head_dim 32, 40 and 128,
   sequences of 77 and 1000, seq_q != seq_k), checks that two launches
   agree bitwise, and times each beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` (forward, or its backward), with its
   share of the bound and its compiled registers and shared memory;
7. lm_serve: the full-width transformer LM (vocab 32000, d_model 512, 8
   heads, 4 layers, d_ff 2048, bf16, seeded random weights) computes the
   logits of 8 sequences of 2048 tokens through ``TransformerLM.forward``,
   checks them, that each forward launched ``flash_fwd`` 4 times, and the
   card against the CPU on 1 x 256 tokens in f32, and prints latency and
   tokens per second;
8. lm_train: trains that LM for 8 steps through ``make_train_step`` with
   ``Adam(fused=True)`` on one fixed batch of 8 x 2048 tokens, checks the
   launches per step (4 of each flash kernel, 1 ``fused_adam``), that the
   loss fell and the parameters are finite and moved, and the card's
   gradients at 1 x 256 tokens in f32 against the CPU's, and prints the
   step time, tokens per second and the forward / backward / update split;
9. comm_kernels: holds the six gradient-compression kernels bitwise against
   their plain versions on the card (NaN by position), at ResNet-50's
   padded gradient split into 2, 4 and 8 rows, at (8, 2048) with chunk 256
   and ``block_elems`` 512 and at a 1-D (64,) with chunk 4 (these two with a
   NaN, an inf and a zero chunk), checks that two launches agree bitwise,
   and times each at the two-rank exchange's shapes beside its bound, its
   plain version and the codec path's torch composition;
10. dp_train: two rank processes (spawn, gloo through pinned host buffers)
   share the card and train the full-width ResNet-50 (batch 32 a rank) for
   8 steps through ``FeedForward(ctx=gpu(0), optimizer="adam",
   fused=True).fit(kvstore="dist_sync", compression=..., comm_kernels=True)``
   with int8 and then twobit; checks the launches per step per rank, the
   wire bytes against ``allreduce_plan``, that both ranks' parameters are
   bitwise equal (from different initial weights: rank 0's broadcast), that
   each rank's loss fell, and that the card's sync is bitwise the same
   exchange run on CPU copies; prints the step time, global images per
   second, one step's forward / backward / sync / update split and the
   sync's kernel and host-transfer time;
11. prints one line ``{"kernels": [...]}`` with each kernel's launches on its
   main path, error, times and bound;
12. ends with ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line. Without CUDA it exits non-zero at once. It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
BATCH = 32
IMAGE = (3, 224, 224)
REQUESTS = 8
# (M, K, N): ResNet-50 fc1 at batch 32 and at batch 1, the JAX package's own
# ragged test shape, and a large square-ish product
KERNEL_SHAPES = ((32, 2048, 1000), (1, 2048, 1000), (37, 100, 23),
                 (256, 4096, 4096))
MAIN_SHAPE = KERNEL_SHAPES[0]
KERNEL_SOURCES = ("int8_matmul", "fused_adam", "flash_attention",
                  "comm_kernels")
TRAIN_STEPS = 8
LEARNING_RATE = 1e-3
# tests/test_pallas_kernels.py:259, the JAX package's own odd leaf set
ODD_SHAPES = {"w1": (64, 33), "b1": (33,), "w2": (7, 5), "s": ()}
# the transformer LM: batch x sequence of the full-width runs, requests
# served, training steps, and the cut (batch, sequence) of card-vs-CPU checks
LM_BATCH, LM_SEQ = 8, 2048
LM_REQUESTS = 5
LM_STEPS = 8
LM_CUT = (1, 256)
# (q shape, dtype, causal, seq_k or None for seq_q): the LM's attention, a
# non-causal shape, the JAX package's ragged tail test (tests/test_pallas.py
# :35), and the Hopper kernels' edges at small size: head_dim 32 and 40
# (TMA's zero fill), 128 (two boxes a row), sequences of 77 and 1000 (a
# multiple of neither the 64-row tile nor the 128-row block), seq_q != seq_k
FLASH_CASES = (((LM_BATCH, 8, LM_SEQ, 64), "bfloat16", True, None),
               ((4, 8, 1024, 64), "bfloat16", False, None),
               ((1, 2, 48, 24), "float32", True, None),
               ((2, 2, 77, 32), "bfloat16", True, None),
               ((1, 3, 1000, 40), "bfloat16", True, None),
               ((2, 2, 1000, 128), "bfloat16", False, None),
               ((1, 2, 300, 128), "bfloat16", False, 77),
               ((2, 2, 100, 64), "bfloat16", False, 300))
# data-parallel training: ranks sharing the card, steps, modes, time limit
DP_WORLD = 2
DP_STEPS = 8
DP_MODES = ("int8", "twobit")
DP_TIMEOUT_S = 600
# launches per step per rank on the dp_train path, by mode (the rest: 0)
DP_LAUNCHES = {
    "int8": {"quant_int8": 2, "dequant_sum_int8": 1, "dequant_int8": 1,
             "fused_adam": 1},
    "twobit": {"quant_twobit": 1, "dequant_sum_twobit": 1, "fused_adam": 1},
}
# ResNet-50's gradient: 161 leaves, 25,557,032 elements; int8 chunk
RESNET50_GRAD = 25_557_032
COMM_CHUNK = 256


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=25, spin=2_000_000):
    """Median device time of ``fn`` over ``reps`` calls, each after a flush
    of the 50 MB L2 cache and a spin of ``spin`` clock cycles that holds the
    stream until the host has queued the timed region, so that host launch
    cost stays out."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def centered_logits(p):
    """Log-probabilities less their row mean: the logits up to a per-row
    constant, which the softmax output determines."""
    lp = np.log(p.astype(np.float64))
    return lp - lp.mean(axis=1, keepdims=True)


def rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_card(torch, common):
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    t0 = time.perf_counter()

    def build(stem):
        common.load_library(stem)
        return time.perf_counter() - t0

    # nvcc on a fresh checkout: one compiler per source, all at once
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        library_s = dict(zip(KERNEL_SOURCES, pool.map(build, KERNEL_SOURCES)))
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_loaded": list(KERNEL_SOURCES), "build_s": build_s,
          # each library's build, from the common start (they run at once)
          "library_build_s": library_s})
    return smi


def phase_kernels(torch, k8, registry):
    """int8_matmul against its plain version, and its times."""
    rng = np.random.default_rng(SEED)
    rows, max_err = [], 0.0
    for M, K, N in KERNEL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((N, K), np.float32)).cuda()
        wq, sw = k8.quantize_channels(w)
        plain = k8.int8_matmul_plain(x, wq, sw)
        y_float_w = k8.int8_matmul(x, w)
        y_prequant = k8.int8_matmul(x, wq, w_scale=sw)
        torch.cuda.synchronize()
        err = max(float((y_float_w - plain).abs().max()),
                  float((y_prequant - plain).abs().max()))
        require(torch.equal(y_float_w, plain) and torch.equal(y_prequant, plain),
                f"int8_matmul {M}x{K}x{N} differs from its plain version "
                f"(max abs {err})")
        max_err = max(max_err, err)
        cost = registry.get_kernel("int8_matmul").cost([x, wq, sw], [plain])
        bound_s, bound_by = cost.bound()
        sx = torch.clamp_min(x.abs().amax(1, keepdim=True) * k8.INV_127, 1e-30)
        qx = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
        # torch._int_mm (cuBLASLt) takes M > 16 and K, N multiples of 8
        int_mm_ok = M > 16 and K % 8 == 0 and N % 8 == 0
        row = {
            "phase": "kernel", "name": "int8_matmul", "M": M, "K": K, "N": N,
            "bitwise_equal_plain": True, "max_abs_err": err,
            "ms": time_ms(torch, lambda: k8.int8_matmul(x, wq, w_scale=sw)),
            "plain_ms": time_ms(torch, lambda: k8.int8_matmul_plain(x, wq, sw)),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "int_mm_ms": (time_ms(torch, lambda: torch._int_mm(qx, wq.t()))
                          if int_mm_ok else None),
            "f32_matmul_ms": time_ms(torch, lambda: torch.matmul(x, w.t())),
            "bytes": cost.bytes, "ops": cost.flops,
        }
        emit(row)
        rows.append(row)
    return rows, max_err


def phase_slice(torch, mt, k8):
    """Full-width ResNet-50 served through Predictor on the card."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = resnet50(num_classes=1000)
    data_shape = (BATCH, 3, 224, 224)
    args, aux = random_params(net, SEED, data=data_shape)
    rng = np.random.default_rng(SEED + 1)
    images = [rng.standard_normal(data_shape, np.float32)
              for _ in range(REQUESTS)]

    gpu = mt.gpu(0)
    p8 = mt.Predictor(net, args, aux, ctx=gpu, quantize="int8")
    p32 = mt.Predictor(net, args, aux, ctx=gpu)
    p8.forward(data=images[0]).get_output(0)   # warm-up: cuDNN, allocator
    p32.forward(data=images[0]).get_output(0)
    torch.cuda.synchronize()

    def serve(pred):
        outs, lat = [], []
        for img in images:
            t0 = time.perf_counter()
            outs.append(pred.forward(data=img).get_output(0))
            lat.append((time.perf_counter() - t0) * 1e3)
        return outs, lat

    # the main path: every kernel count is read around the int8 serving run
    k8.int8_matmul.launches = 0
    out8, lat8 = serve(p8)
    launches = {"int8_matmul": k8.int8_matmul.launches}
    out32, lat32 = serve(p32)

    for o in out8 + out32:
        require(o.shape == (BATCH, 1000) and np.isfinite(o).all(),
                "outputs are finite (32, 1000)")
    require(launches["int8_matmul"] == REQUESTS,
            f"int8_matmul launched {launches['int8_matmul']} times in "
            f"{REQUESTS} int8 requests (ResNet-50 has one FullyConnected)")
    o8, o32 = np.concatenate(out8), np.concatenate(out32)
    # Per-row int8 quantization of the pooled post-ReLU features, whose
    # largest entries set each row's scale, costs 1-2% of the logits with
    # these weights (CPU rehearsal: 1.4e-2), hence 3e-2.
    logit_err = rel_fro(centered_logits(o8), centered_logits(o32))
    require(logit_err < 3e-2, f"int8 vs f32 logits rel. error {logit_err}")
    agree = float((o8.argmax(1) == o32.argmax(1)).mean())
    require(agree >= 0.9, f"int8 vs f32 argmax agreement {agree}")

    # The card against the CPU (plain int8 version, oneDNN convolutions) on
    # two images. Both sum in f32 in different orders through 53 layers, and
    # in int8 a feature on a rounding boundary may move its code by one step,
    # as the CPU tests allow (1e-3). Readings on the H100 were 1.5e-7 to
    # 3.6e-7 for both (PERF.md), so 1e-3 leaves room for these and no more.
    for quant, out, bound in ((None, out32[0], 1e-3), ("int8", out8[0], 1e-3)):
        ref = mt.Predictor(net, args, aux, ctx=mt.cpu(), quantize=quant)
        ref_out = ref.forward(data=images[0][:2]).get_output(0)
        err = rel_fro(centered_logits(out[:2]), centered_logits(ref_out))
        require(err < bound, f"card vs CPU ({quant}) logits rel. error {err}")
        emit({"phase": "card_vs_cpu", "quantize": quant, "rel_err": err,
              "bound": bound})

    # where an int8 request's time goes, on the host clock: the input's copy
    # to the card, the forward, the output's copy back
    split = {"set_input_ms": [], "forward_ms": [], "get_output_ms": []}
    for img in images:
        t0 = time.perf_counter()
        p8.set_input("data", img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p8.forward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        p8.get_output(0)
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(dt * 1e3)
    emit({"phase": "int8_request_split",
          **{k: statistics.median(v) for k, v in split.items()}})

    row = {"phase": "slice", "model": "resnet50", "batch": BATCH,
           "image": [3, 224, 224], "classes": 1000, "requests": REQUESTS,
           "int8_logit_rel_err": logit_err, "int8_argmax_agree": agree,
           "launches": launches}
    for tag, lat in (("int8", lat8), ("f32", lat32)):
        med = statistics.median(lat)
        row[f"{tag}_request_ms"] = lat
        row[f"{tag}_request_ms_median"] = med
        row[f"{tag}_images_per_s"] = BATCH * 1e3 / med
    emit(row)
    return launches


def resnet50_leaf_shapes():
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, 3, 224, 224))
    return {n: s for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def adam_configs(topt):
    """The two step kinds the kernel serves: Adam with rescale, clip and L2
    decay through the gradient, and AdamW with a decay filter."""
    return {
        "adam": lambda fused: topt.Adam(
            learning_rate=LEARNING_RATE, rescale_grad=1.0 / BATCH,
            clip_gradient=1.0, wd=1e-4, fused=fused),
        "adamw": lambda fused: topt.AdamW(
            learning_rate=LEARNING_RATE, rescale_grad=1.0 / BATCH,
            weight_decay=0.05, decay_filter=lambda n: n.endswith("_weight"),
            fused=fused),
    }


def phase_fused_adam(torch, topt, kfa, registry):
    """fused_adam against its plain version and the per-leaf path, bitwise,
    over 3 steps; then its times at ResNet-50's parameter set."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    max_err, rows = 0.0, {}
    for set_name, shapes in (("resnet50", resnet50_leaf_shapes()),
                             ("odd", ODD_SHAPES)):
        names = list(shapes)
        w0 = {k: randn(shapes[k]) for k in names}
        # gradients of a batch sum: large enough that rescale and clip act
        grads = [{k: randn(shapes[k], 2.0 * BATCH) for k in names}
                 for _ in range(3)]
        for cfg_name, make in adam_configs(topt).items():
            opt_k, opt_p, opt_l = make(True), make(True), make(False)
            pk = {k: v.clone() for k, v in w0.items()}
            pp = {k: v.clone() for k, v in w0.items()}
            pl = {k: v.clone() for k, v in w0.items()}
            sk, sp, sl = (o.init_state_tree(pk) for o in (opt_k, opt_p, opt_l))
            for step in range(3):
                g = grads[step]
                with torch.no_grad():
                    pk, sk = opt_k.apply(pk, g, sk, LEARNING_RATE)
                    t_new, scalars, hyper = opt_p._fused_args(names, sp)
                    kfa.fused_adam_plain(
                        [pp[k] for k in names], [g[k] for k in names],
                        [sp[k][0] for k in names], [sp[k][1] for k in names],
                        *scalars, lr=LEARNING_RATE, **hyper)
                    sp = {k: (sp[k][0], sp[k][1], t_new[k]) for k in names}
                    pl, sl = opt_l.apply(pl, g, sl, LEARNING_RATE)
                torch.cuda.synchronize()
                for k in names:
                    for kern, plain, leaf in ((pk[k], pp[k], pl[k]),
                                              (sk[k][0], sp[k][0], sl[k][0]),
                                              (sk[k][1], sp[k][1], sl[k][1])):
                        err = float((kern - plain).abs().max()) \
                            if kern.numel() else 0.0
                        max_err = max(max_err, err)
                        require(torch.equal(kern, plain),
                                f"fused_adam {set_name}/{cfg_name} step {step} "
                                f"leaf {k}: kernel differs from its plain "
                                f"version (max abs {err})")
                        require(torch.equal(kern, leaf),
                                f"fused_adam {set_name}/{cfg_name} step {step} "
                                f"leaf {k}: kernel differs from the per-leaf "
                                "Optimizer.apply")
            emit({"phase": "fused_adam_parity", "set": set_name,
                  "config": cfg_name, "leaves": len(names), "steps": 3,
                  "bitwise_equal_plain": True,
                  "bitwise_equal_per_leaf": True})
        if set_name != "resnet50":
            continue
        # times at ResNet-50's set, Adam step, the main path's shapes
        opt = adam_configs(topt)["adam"](True)
        ws = [w0[k].clone() for k in names]
        gs = [grads[0][k] for k in names]
        states = opt.init_state_tree(dict(zip(names, ws)))
        ms = [states[k][0] for k in names]
        vs = [states[k][1] for k in names]
        _, scalars, hyper = opt._fused_args(names, states)
        table = kfa.LeafTable()

        def kernel():
            kfa.fused_adam(ws, gs, ms, vs, *scalars, lr=LEARNING_RATE,
                           table=table, **hyper)

        def plain():
            kfa.fused_adam_plain(ws, gs, ms, vs, *scalars, lr=LEARNING_RATE,
                                 **hyper)

        lib_params = [w.clone().requires_grad_(True) for w in ws]
        for p_, g_ in zip(lib_params, gs):
            p_.grad = g_.clone()
        lib_opt = torch.optim.Adam(lib_params, lr=LEARNING_RATE,
                                   weight_decay=1e-4, fused=True)
        cost = registry.get_kernel("fused_adam").cost([ws, gs, ms, vs],
                                                      [ws, ms, vs])
        bound_s, bound_by = cost.bound()
        with torch.no_grad():
            # the wrapper's host work (checks of 644 tensors, the per-step
            # table) can outlast the default spin on a slow host
            rows = {"ms": time_ms(torch, kernel, spin=10_000_000),
                    "plain_ms": time_ms(torch, plain, reps=5),
                    "library_ms": time_ms(torch, lib_opt.step,
                                          spin=10_000_000),
                    "bound_ms": bound_s * 1e3, "bound_by": bound_by}
        emit({"phase": "kernel", "name": "fused_adam", "set": set_name,
              "leaves": len(names), "elements": sum(w.numel() for w in ws),
              "work_items": table.n_items, "bytes": cost.bytes,
              "ops": cost.flops, **rows,
              "library": "torch.optim.Adam(fused=True).step()"})
    return rows, max_err


def step_loss_metric(mt):
    """A metric holding SoftmaxOutput.loss_value of each step's training
    outputs, per image; reading it syncs the host with the step."""
    from mxnet_tpu_torch.ops import OPS

    head = OPS.create("SoftmaxOutput")

    class StepLoss(mt.metric.EvalMetric):
        def __init__(self):
            super().__init__("softmax_loss")
            self.steps = []

        def update(self, labels, preds):
            value = float(head.loss_value(preds[0], labels[0])) / BATCH
            self.steps.append(value)
            self.sum_metric += value
            self.num_inst += 1

    return StepLoss()


def phase_train(torch, mt, kfa):
    """Full-width ResNet-50 trained through FeedForward.fit on the card."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = resnet50(num_classes=1000)
    shape = (BATCH, 3, 224, 224)
    args, aux = random_params(net, SEED, data=shape)
    rng = np.random.default_rng(SEED + 2)
    batch_x = rng.standard_normal(shape, np.float32)
    batch_y = rng.integers(0, 1000, BATCH).astype(np.float32)
    # one fixed batch every step: the run overfits it, so its loss must fall
    X = np.ascontiguousarray(np.broadcast_to(
        batch_x, (TRAIN_STEPS,) + shape).reshape((-1,) + shape[1:]))
    Y = np.tile(batch_y, TRAIN_STEPS)
    metric, stamps = step_loss_metric(mt), []
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    # the main path: the kernel's count is read around the fit
    kfa.fused_adam.launches = 0
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH), eval_metric=metric,
              batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    launches = {"fused_adam": kfa.fused_adam.launches}
    table_builds = model._optimizer_obj._leaf_table.builds
    require(launches["fused_adam"] == TRAIN_STEPS,
            f"fused_adam launched {launches['fused_adam']} times in "
            f"{TRAIN_STEPS} steps (one whole-tree launch per step)")
    losses = metric.steps
    require(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
            f"finite loss at every step: {losses}")
    require(losses[-1] < losses[0],
            f"the loss of the overfit batch fell: {losses[0]} -> {losses[-1]}")
    for k, v in model.arg_params.items():
        v = v.numpy()
        require(np.isfinite(v).all(), f"parameter {k} is finite")
        require(not np.array_equal(v, args[k]), f"parameter {k} changed")
    for k, v in model.aux_params.items():
        require(np.isfinite(v.numpy()).all(), f"auxiliary state {k} is finite")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms)

    # one step split into its phases, on the card's clock
    state = model._train_state
    arrays = {"data": torch.from_numpy(batch_x).cuda(),
              "softmax_label": torch.from_numpy(batch_y).cuda()}
    split = {"forward_ms": [], "backward_ms": [], "update_ms": []}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        state.forward(arrays)
        ev[1].record()
        state.backward()
        ev[2].record()
        state.update(LEARNING_RATE)
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, zip(ev, ev[1:])):
            split[key].append(a.elapsed_time(b))
    split = {k: statistics.median(v) for k, v in split.items()}

    # the card against the CPU: one forward+backward at batch 4, the same
    # params and images; per-leaf relative Frobenius error of the gradients.
    # Both f32 runs are also held against the CPU in f64: at batch 4 the last
    # stage's BatchNorms normalise 196 values a channel, and f32 gradients of
    # this random ResNet-50 carry 0.2-1% error on either device (readings in
    # PERF.md), so the card must be as close to f64 as the CPU is.
    small = (4,) + shape[1:]

    def bound_grads(ctx, dtype):
        names = net.list_arguments()
        values = {k: v.astype(dtype) for k, v in args.items()}
        values.update(data=batch_x[:4].astype(dtype),
                      softmax_label=batch_y[:4])
        ex = net.bind(ctx, values,
                      args_grad={k: np.zeros(v.shape, dtype)
                                 for k, v in args.items()},
                      grad_req={k: "write" if k in args else "null"
                                for k in names},
                      aux_states={k: v.astype(dtype) for k, v in aux.items()})
        ex.forward(is_train=True)
        ex.backward()
        return {k: ex.grad_dict[k].cpu().double().numpy() for k in args}

    def leaf_errors(got, want):
        return {k: float(np.linalg.norm(got[k] - want[k])
                         / max(np.linalg.norm(want[k]), 1e-30)) for k in args}

    card = bound_grads(mt.gpu(0), np.float32)
    host = bound_grads(mt.cpu(), np.float32)
    exact = bound_grads(mt.cpu(), np.float64)
    errs = {"card_vs_cpu": leaf_errors(card, host),
            "card_vs_f64": leaf_errors(card, exact),
            "cpu_vs_f64": leaf_errors(host, exact)}
    summary = {name: {"median": statistics.median(e.values()),
                      "worst": sorted(e.items(), key=lambda kv: -kv[1])[:3]}
               for name, e in errs.items()}
    emit({"phase": "card_vs_cpu_grads", "batch": 4, "leaves": len(args),
          **summary, "bounds": {"card_vs_cpu_worst": 3e-2,
                                "card_vs_cpu_median": 1e-2,
                                "card_over_cpu_vs_f64": [2.0, 3.0]}})
    worst = summary["card_vs_cpu"]["worst"][0]
    require(worst[1] < 3e-2 and summary["card_vs_cpu"]["median"] < 1e-2,
            f"card vs CPU gradient rel. error {worst[1]} at {worst[0]}, "
            f"median {summary['card_vs_cpu']['median']}")
    for stat, factor in (("median", 2.0), ("worst", 3.0)):
        def pick(name):
            v = summary[name][stat]
            return v if stat == "median" else v[0][1]
        require(pick("card_vs_f64") <= factor * pick("cpu_vs_f64"),
                f"card gradients {pick('card_vs_f64')} from f64 ({stat}) "
                f"against the CPU's {pick('cpu_vs_f64')}")
    emit({"phase": "train", "model": "resnet50", "batch": BATCH,
          "image": [3, 224, 224], "classes": 1000, "steps": TRAIN_STEPS,
          "optimizer": "adam", "fused": True, "learning_rate": LEARNING_RATE,
          "launches": launches, "leaf_table_builds": table_builds,
          "loss_first": losses[0],
          "loss_last": losses[-1], "step_ms": step_ms,
          "step_ms_median": median_ms,
          "images_per_s": BATCH * 1e3 / median_ms, "split": split})
    return launches


def flash_row_bound(torch, dtype):
    """Kernel against plain version, row by row: each (batch, head, row)'s
    error over head_dim (rows of o and dq are queries, of dk and dv keys)
    within ``tol`` of that row's norm, plus ``ROW_FLOOR`` of the slab's RMS
    row norm, so that late causal rows and keys, whose values are a few
    hundredths, are held about as tightly as the large ones. Sums run in
    another order (mma fragments against blocked matmuls; no atomics, so the
    kernel repeats itself bitwise), and in bf16 an output, p or ds may round
    to the other neighbour: one bf16 step of each element is at most 2^-7
    of its row (readings up to 3.6e-3). In f32, 1e-5 (readings up to
    7.7e-7)."""
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


# A row whose value cancels to rounding noise (dq of the first query, which
# sees one key: dp - delta is zero up to f32 rounding) has no relative error
# to hold; its noise read 0.7-1.8e-6 of the slab's RMS row norm, and
# 2^-16 = 1.5e-5 of it leaves room for that and for nothing a real row holds.
ROW_FLOOR = 2.0 ** -16
# lse is f32 on both sides: |error| <= 1e-5 * max(1, |lse|)
LSE_BOUND = 1e-5


def row_errors(torch, got, want, tol):
    """``(error / allowed, error / norm)`` per (batch, head, row), the second
    over the rows whose norm is at least 2^-7 of the slab's RMS (rows not
    lost to cancellation)."""
    g, w = got.float(), want.float()
    err, norm = (g - w).norm(dim=-1), w.norm(dim=-1)
    rms = norm.pow(2).mean(-1, keepdim=True).sqrt()
    share = err / (tol * norm + ROW_FLOOR * rms).clamp_min(
        torch.finfo(torch.float32).tiny)
    real = norm >= 2.0 ** -7 * rms
    rel = torch.where(real, err / norm.clamp_min(
        torch.finfo(torch.float32).tiny), torch.zeros_like(err))
    return share, rel


def flash_operands(torch, shape, dtype, gen, seq_k=None):
    """q, k, v as the transformer hands them (views of one packed
    (b, s, 3, h, d) qkv), and do; with ``seq_k``, k and v of their own."""
    b, h, s, d = shape
    if seq_k is None:
        qkv = torch.randn((b, s, 3, h, d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    else:
        q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, seq_k, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def phase_flash(torch, tfa, registry):
    """The three flash kernels against their plain versions, and their
    times at the LM's shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    rows = {}
    for shape, dtype_name, causal, seq_k in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = flash_operands(torch, shape, dtype, gen, seq_k)
        o, lse = tfa.flash_fwd(q, k, v, causal)
        delta = tfa.attention_delta(o, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        again = (*tfa.flash_fwd(q, k, v, causal),
                 tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                 *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
        po, plse = tfa.flash_fwd_plain(q, k, v, causal)
        pdq, pdk, pdv = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in
                    zip((o, lse, dq, dk, dv), again)),
                f"flash kernels {shape} repeat themselves bitwise")
        bound = flash_row_bound(torch, dtype)
        lse_err = float(((lse - plse).abs() / plse.abs().clamp_min(1)).max())
        case = {"lse": {"max_rel_err": lse_err,
                        "max_abs_err": float((lse - plse).abs().max())}}
        shares = {}
        for kernel, name, got, want in (
                ("flash_fwd", "o", o, po), ("flash_bwd_dq", "dq", dq, pdq),
                ("flash_bwd_dkv", "dk", dk, pdk),
                ("flash_bwd_dkv", "dv", dv, pdv)):
            share, rel = row_errors(torch, got, want, bound)
            shares[name] = (kernel, float(share.max()))
            err = float((got.float() - want.float()).abs().max())
            errs[kernel] = max(errs[kernel], err)
            late = rel[..., 3 * rel.shape[-1] // 4:]
            case[name] = {"max_abs_err": err,
                          "share_of_bound_max": shares[name][1],
                          "row_rel_err_max": float(rel.max()),
                          "row_rel_err_median": float(rel.median()),
                          # the last quarter of rows: late queries or keys
                          "row_rel_err_max_late": float(late.max())}
        errs["flash_fwd"] = max(errs["flash_fwd"], case["lse"]["max_abs_err"])
        emit({"phase": "flash_parity", "shape": list(shape),
              "seq_k": k.shape[2], "dtype": dtype_name, "causal": causal,
              "errors": case,
              "row_rel_bound": bound, "row_floor_of_rms": ROW_FLOOR,
              "lse_rel_bound": LSE_BOUND, "bitwise_repeat": True})
        require(lse_err <= LSE_BOUND,
                f"flash_fwd {shape} {dtype_name} causal={causal}: lse differs "
                f"from the plain version by {lse_err} relative")
        for name, (kernel, worst) in shares.items():
            require(worst <= 1.0,
                    f"{kernel} {shape} {dtype_name} causal={causal}: a row of "
                    f"{name} differs from the plain version by {worst} of "
                    f"its bound ({bound} of its norm + {ROW_FLOOR} of the "
                    "RMS row)")
        if shape != FLASH_CASES[0][0]:
            continue
        # times at the LM's shape; the library call gets contiguous copies
        qc, kc, vc = (t.detach().contiguous().requires_grad_(True)
                      for t in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal)
        costs = {
            "flash_fwd": registry.get_kernel("flash_fwd").cost(
                [q, k, v], [o, lse], causal=causal),
            "flash_bwd_dq": registry.get_kernel("flash_bwd_dq").cost(
                [q, k, v, do, lse, delta], [dq], causal=causal),
            "flash_bwd_dkv": registry.get_kernel("flash_bwd_dkv").cost(
                [q, k, v, do, lse, delta], [dk, dv], causal=causal),
        }
        plain_bwd_ms = time_ms(torch, lambda: tfa.flash_bwd_plain(
            q, k, v, do, lse, delta, causal), reps=5)
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_o, (qc, kc, vc), do, retain_graph=True))
        timed = {
            "flash_fwd": (
                time_ms(torch, lambda: tfa.flash_fwd(q, k, v, causal)),
                time_ms(torch, lambda: tfa.flash_fwd_plain(q, k, v, causal),
                        reps=5),
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal))),
            "flash_bwd_dq": (
                time_ms(torch, lambda: tfa.flash_bwd_dq(
                    q, k, v, do, lse, delta, causal)),
                plain_bwd_ms, lib_bwd_ms),
            "flash_bwd_dkv": (
                time_ms(torch, lambda: tfa.flash_bwd_dkv(
                    q, k, v, do, lse, delta, causal)),
                plain_bwd_ms, lib_bwd_ms),
        }
        for name, (ms, plain_ms, lib_ms) in timed.items():
            bound_s, bound_by = costs[name].bound()
            rows[name] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_s * 1e3,
                          "bound_by": bound_by}
            emit({"phase": "kernel", "name": name, "shape": list(shape),
                  "dtype": dtype_name, "causal": causal,
                  "ops": costs[name].flops, "bytes": costs[name].bytes,
                  **rows[name], "share_of_bound": bound_s * 1e3 / ms,
                  # the compiled kernel this call launches, per block
                  "attributes": tfa.kernel_attributes(name, dtype,
                                                      shape[3]),
                  "library": ("F.scaled_dot_product_attention"
                              if name == "flash_fwd" else
                              "its backward (dq, dk and dv together)"),
                  "plain": ("flash_fwd_plain" if name == "flash_fwd" else
                            "flash_bwd_plain (dq, dk and dv together)")})
    return rows, errs


def lm_tokens(rng, batch, seq, vocab):
    return (rng.integers(0, vocab, (batch, seq)),
            rng.integers(0, vocab, (batch, seq)))


def lm_card_vs_cpu(torch, mt, TransformerLM, transformer_lm_config, params):
    """Logits and gradients of the f32 LM at the cut size, on the card
    (flash kernels) and on the CPU (dense attention), from the same
    parameters: relative Frobenius errors."""
    cfg = transformer_lm_config(dtype=torch.float32)
    model = TransformerLM(cfg)
    tokens, targets = lm_tokens(np.random.default_rng(SEED + 5), *LM_CUT,
                                cfg["vocab_size"])
    out = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        dev = ctx.torch_device
        leaves = {k: v.detach().to(dev).requires_grad_(True)
                  for k, v in params.items()}
        logits = model.forward(leaves, torch.from_numpy(tokens))
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg["vocab_size"]),
            torch.from_numpy(targets).to(dev).reshape(-1))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[ctx.device_type] = (
            logits.detach().cpu().double().numpy(),
            {k: g.cpu().double().numpy() for k, g in zip(leaves, grads)})
    card, host = out["gpu"], out["cpu"]
    logit_err = rel_fro(card[0], host[0])
    grad_errs = {k: float(np.linalg.norm(card[1][k] - host[1][k])
                          / max(np.linalg.norm(host[1][k]), 1e-30))
                 for k in params}
    return logit_err, grad_errs


def phase_lm_serve(torch, mt, tfa):
    """The full-width LM's forward on the card: logits of 8 x 2048 tokens."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config

    # the f32 card-vs-CPU check below; the bf16 GEMMs' rounding is the model's
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    params = model.init_params(SEED, ctx=mt.gpu(0))
    rng = np.random.default_rng(SEED + 3)
    requests = [torch.from_numpy(lm_tokens(rng, LM_BATCH, LM_SEQ,
                                           cfg["vocab_size"])[0]).cuda()
                for _ in range(LM_REQUESTS)]
    with torch.no_grad():
        model.forward(params, requests[0])   # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        # the main path: the kernel's count is read around the requests
        tfa.flash_fwd.launches = 0
        lat, finite = [], True
        for tokens in requests:
            t0 = time.perf_counter()
            logits = model.forward(params, tokens)
            finite = finite and bool(torch.isfinite(logits).all())
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = {"flash_fwd": tfa.flash_fwd.launches}
    require(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg["vocab_size"])
            and logits.dtype == torch.float32 and finite,
            f"logits are finite f32 {(LM_BATCH, LM_SEQ, cfg['vocab_size'])}")
    require(launches["flash_fwd"] == cfg["n_layers"] * LM_REQUESTS,
            f"flash_fwd launched {launches['flash_fwd']} times in "
            f"{LM_REQUESTS} forwards of {cfg['n_layers']} layers")
    del logits
    # The card (flash kernels, f32 on the CUDA cores, cuBLAS f32 without
    # TF32) against the CPU (dense attention) in f32 at 1 x 256 tokens:
    # sums in other orders through 4 layers and a 32000-way projection.
    # 1e-5 leaves room above f32's rounding (the CPU tests read 1e-7 at
    # their width) and none for a wrong mask, scale or tile.
    logit_err, grad_errs = lm_card_vs_cpu(torch, mt, TransformerLM,
                                          transformer_lm_config, params)
    require(logit_err < 1e-5, f"LM card vs CPU logits rel. error {logit_err}")
    med = statistics.median(lat)
    emit({"phase": "lm_serve", "batch": LM_BATCH, "seq": LM_SEQ,
          "config": {k: str(v) for k, v in cfg.items()},
          "params": sum(v.numel() for v in params.values()),
          "requests": LM_REQUESTS, "launches": launches,
          "card_vs_cpu_logits_rel_err": logit_err, "bound": 1e-5,
          "request_ms": lat, "request_ms_median": med,
          "tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / med})
    return launches, params, grad_errs


def phase_lm_train(torch, mt, topt, tfa, kfa, params0, grad_errs):
    """The full-width LM trained 8 steps through make_train_step with the
    fused Adam step, on one fixed batch."""
    from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config

    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    opt = topt.create("adam", learning_rate=LEARNING_RATE, fused=True)
    params = {k: v.clone() for k, v in params0.items()}
    state = opt.init_state_tree(params)
    step = model.make_train_step(None, optimizer=opt)
    tokens, targets = (torch.from_numpy(t).cuda() for t in lm_tokens(
        np.random.default_rng(SEED + 4), LM_BATCH, LM_SEQ,
        cfg["vocab_size"]))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    kernels = {n: getattr(tfa, n) for n in names}
    kernels["fused_adam"] = kfa.fused_adam
    torch.cuda.synchronize()
    # the main path: every count is read around the 8 steps
    for fn in kernels.values():
        fn.launches = 0
    losses, stamps = [], [time.perf_counter()]
    for _ in range(LM_STEPS):
        params, state, loss = step(params, state, tokens, targets)
        losses.append(float(loss))   # syncs the host with the step
        stamps.append(time.perf_counter())
    launches = {n: fn.launches for n, fn in kernels.items()}
    per_step = {"flash_fwd": cfg["n_layers"], "flash_bwd_dq": cfg["n_layers"],
                "flash_bwd_dkv": cfg["n_layers"], "fused_adam": 1}
    for n, k in per_step.items():
        require(launches[n] == k * LM_STEPS,
                f"{n} launched {launches[n]} times in {LM_STEPS} steps "
                f"(expected {k} a step)")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"the loss of the fixed batch fell: {losses}")
    for k, v in params.items():
        require(bool(torch.isfinite(v).all()), f"parameter {k} is finite")
        require(not torch.equal(v, params0[k]), f"parameter {k} changed")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    median_ms = statistics.median(step_ms)

    # one step split into its phases, on the card's clock
    split = {"forward_ms": [], "backward_ms": [], "update_ms": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = model.loss(leaves, tokens, targets)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        with torch.no_grad():
            grads = {k: g.contiguous() for k, g in zip(leaves, grads)}
            params, state = opt.apply(params, grads, state, opt.lr)
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, zip(ev, ev[1:])):
            split[key].append(a.elapsed_time(b))
    split = {k: statistics.median(v) for k, v in split.items()}

    # The card's f32 gradients at 1 x 256 tokens against the CPU's (taken in
    # lm_card_vs_cpu, from the same initial parameters): the same sums in
    # other orders, per leaf relative Frobenius error. The embedding rows of
    # tokens seen once carry one token's gradient and are the noisiest.
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:3]
    median_err = statistics.median(grad_errs.values())
    emit({"phase": "lm_card_vs_cpu_grads", "cut": list(LM_CUT),
          "leaves": len(grad_errs), "median": median_err, "worst": worst,
          "bounds": {"worst": 1e-4, "median": 1e-5}})
    require(worst[0][1] < 1e-4 and median_err < 1e-5,
            f"LM card vs CPU gradient rel. error {worst[0]}, median "
            f"{median_err}")
    emit({"phase": "lm_train", "batch": LM_BATCH, "seq": LM_SEQ,
          "steps": LM_STEPS, "optimizer": "adam", "fused": True,
          "learning_rate": LEARNING_RATE, "launches": launches,
          "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
          "step_ms": step_ms, "step_ms_median": median_ms,
          "tokens_per_s": LM_BATCH * LM_SEQ * 1e3 / median_ms,
          "split": split})
    return launches


def bits_equal(torch, a, b):
    """Bitwise equal, NaN by position (the sign and payload of a NaN are
    the device's)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(na, nb) and torch.equal(a[~na].view(ints),
                                               b[~nb].view(ints))


def comm_rows(torch, gen, shape, chunk, specials=False):
    """Gaussian rows whose chunks differ in scale by up to e^±6; with
    ``specials`` a NaN chunk, an inf chunk, a -inf and an all-zero chunk."""
    x = torch.randn(shape, generator=gen, device="cuda")
    n = x.numel()
    scales = torch.empty(-(-n // chunk), device="cuda").uniform_(
        -6, 6, generator=gen).exp()
    x = (x.reshape(-1) * scales.repeat_interleave(chunk)[:n]).reshape(shape)
    if specials:
        flat = x.view(-1)
        flat[1] = float("nan")
        flat[chunk + 2] = float("inf")
        flat[2 * chunk + 3] = float("-inf")
        flat[3 * chunk:4 * chunk] = 0.0
    return x


def comm_padded(comm, mode, world):
    return comm.padded_flat_size(RESNET50_GRAD, comm.CompressionSpec(mode),
                                 world)


def phase_comm_kernels(torch, ck, comm, registry):
    """The six comm kernels against their plain versions on the card,
    bitwise; then their times at ResNet-50's two-rank exchange."""
    from mxnet_tpu_torch.comm.allreduce import _row_sum

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for k in ck.KERNELS:
        k.launches = 0
    cases = [((r, comm_padded(comm, "int8", r) // r), COMM_CHUNK, None, False)
             for r in (2, 4, 8)]
    cases += [((8, 2048), COMM_CHUNK, 512, True), ((64,), 4, None, True)]
    for shape, chunk, block, specials in cases:
        for mode in ("int8", "twobit"):
            spec = comm.CompressionSpec(mode, chunk=chunk)
            x = comm_rows(torch, gen, shape, chunk, specials)
            rows = x if x.dim() == 2 else x[None]
            payload, dq = ck.fused_quantize(spec, x, want_dequant=True,
                                            block_elems=block)
            again = ck.fused_quantize(spec, x, want_dequant=True,
                                      block_elems=block)
            kp = {k: v if v.dim() == 2 else v[None] for k, v in payload.items()}
            if mode == "int8":
                plain = ck.quant_int8_plain(rows, chunk, True)[:3]
                got = (kp["q"], kp["scale"], dq.reshape(rows.shape))
                # the error feedback's x - dq, in both of its roundings
                for rounding in ("fma", "sub"):
                    got += (ck.quant_int8(rows, chunk, err=rounding)[3],)
                    plain += (ck.quant_int8_plain(rows, chunk, False,
                                                  rounding)[3],)
                summed = (ck.dequant_sum_int8(kp["q"], kp["scale"], chunk),
                          ck.dequant_sum_int8_plain(kp["q"], kp["scale"],
                                                    chunk))
                decoded = (ck.dequant_int8(kp["q"], kp["scale"], chunk),
                           ck.dequant_int8_plain(kp["q"], kp["scale"], chunk))
                names = ("quant_int8", "dequant_sum_int8", "dequant_int8")
            else:
                plain = ck.quant_twobit_plain(rows, spec.threshold, True)
                got = (kp["q"], dq.reshape(rows.shape))
                summed = (ck.dequant_sum_twobit(kp["q"], spec.threshold),
                          ck.dequant_sum_twobit_plain(kp["q"], spec.threshold))
                decoded = (ck.dequant_twobit(kp["q"], spec.threshold),
                           ck.dequant_twobit_plain(kp["q"], spec.threshold))
                names = ("quant_twobit", "dequant_sum_twobit",
                         "dequant_twobit")
            repeat = (ck.fused_dequant_sum(spec, kp, block_elems=block),
                      ck.fused_dequant(spec, kp, block_elems=block))
            torch.cuda.synchronize()
            checks = {
                names[0]: all(bits_equal(torch, a, b)
                              for a, b in zip(got, plain)),
                names[1]: bits_equal(torch, *summed),
                names[2]: bits_equal(torch, *decoded)}
            for name, ok in checks.items():
                require(ok, f"{name} {list(shape)} chunk {chunk}: kernel "
                        "differs from its plain version")
            require(all(bits_equal(torch, payload[k], again[0][k])
                        for k in payload)
                    and bits_equal(torch, dq, again[1])
                    and bits_equal(torch, summed[0], repeat[0])
                    and bits_equal(torch, decoded[0].reshape(repeat[1].shape),
                                   repeat[1]),
                    f"comm kernels {mode} {list(shape)} repeat bitwise")
            emit({"phase": "comm_parity", "mode": mode, "shape": list(shape),
                  "chunk": chunk, "block_elems": block,
                  "nan_inf_chunks": specials, "bitwise_equal_plain": True,
                  "bitwise_repeat": True})
    phase_launches = {k.__name__: k.launches for k in ck.KERNELS}

    # times at the main path's shapes: ResNet-50's padded gradient, two ranks
    rows = {}
    for mode in ("int8", "twobit"):
        spec = comm.CompressionSpec(mode)
        x = comm_rows(torch, gen, (2, comm_padded(comm, mode, 2) // 2),
                      COMM_CHUNK)
        payload, dq = ck.fused_quantize(spec, x, want_dequant=True)
        shard = ck.fused_dequant_sum(spec, payload)
        decoded = ck.fused_dequant(spec, payload)
        if mode == "int8":
            q, scale = payload["q"], payload["scale"]
            timed = {
                "quant_int8": (
                    lambda: ck.quant_int8(x, COMM_CHUNK, True),
                    lambda: ck.quant_int8_plain(x, COMM_CHUNK, True),
                    lambda: comm.decode(spec, comm.encode(spec, x)),
                    [x], [q, scale, dq]),
                "dequant_sum_int8": (
                    lambda: ck.dequant_sum_int8(q, scale, COMM_CHUNK),
                    lambda: ck.dequant_sum_int8_plain(q, scale, COMM_CHUNK),
                    lambda: _row_sum(comm.decode(spec, payload)),
                    [q, scale], [shard]),
                "dequant_int8": (
                    lambda: ck.dequant_int8(q, scale, COMM_CHUNK),
                    lambda: ck.dequant_int8_plain(q, scale, COMM_CHUNK),
                    lambda: comm.decode(spec, payload),
                    [q, scale], [decoded]),
            }
        else:
            q, t = payload["q"], spec.threshold
            timed = {
                "quant_twobit": (
                    lambda: ck.quant_twobit(x, t, True),
                    lambda: ck.quant_twobit_plain(x, t, True),
                    lambda: comm.decode(spec, comm.encode(spec, x)),
                    [x], [q, dq]),
                "dequant_sum_twobit": (
                    lambda: ck.dequant_sum_twobit(q, t),
                    lambda: ck.dequant_sum_twobit_plain(q, t),
                    lambda: _row_sum(comm.decode(spec, payload)),
                    [q], [shard]),
                "dequant_twobit": (
                    lambda: ck.dequant_twobit(q, t),
                    lambda: ck.dequant_twobit_plain(q, t),
                    lambda: comm.decode(spec, payload),
                    [q], [decoded]),
            }
        for name, (kernel, plain, codec, ins, outs) in timed.items():
            cost = registry.get_kernel(name).cost(ins, outs)
            bound_s, bound_by = cost.bound()
            rows[name] = {"ms": time_ms(torch, kernel),
                          "plain_ms": time_ms(torch, plain, reps=5),
                          "library_ms": time_ms(torch, codec),
                          "bound_ms": bound_s * 1e3, "bound_by": bound_by}
            emit({"phase": "kernel", "name": name,
                  "shapes": [list(t.shape) for t in ins],
                  "bytes": cost.bytes, "ops": cost.flops, **rows[name],
                  "library": "the codec path's torch composition",
                  "phase_launches": phase_launches[name]})
        if mode == "int8":
            # the stage-2 form: the reduced shard, one row, with its error in
            # the rounding of a many-step JAX grid
            row = shard[None]
            s_q, s_scale, _, s_err = ck.quant_int8(row, COMM_CHUNK, err="sub")
            cost = registry.get_kernel("quant_int8").cost(
                [row], [s_q, s_scale, s_err])
            bound_s, bound_by = cost.bound()
            emit({"phase": "kernel", "name": "quant_int8",
                  "form": "stage 2: one row and its error, err='sub'",
                  "shapes": [list(row.shape)], "bytes": cost.bytes,
                  "ops": cost.flops,
                  "ms": time_ms(torch, lambda: ck.quant_int8(
                      row, COMM_CHUNK, err="sub")),
                  "plain_ms": time_ms(torch, lambda: ck.quant_int8_plain(
                      row, COMM_CHUNK, False, "sub"), reps=5),
                  "bound_ms": bound_s * 1e3, "bound_by": bound_by})
            del row, s_q, s_scale, s_err
        del x, payload, dq, shard, decoded, timed
    return rows, phase_launches


def dp_train_rank(torch, rank, world, mode):
    """One rank's dp_train run in ``mode``: ResNet-50 through
    ``fit(kvstore="dist_sync", compression=mode, comm_kernels=True)``, then
    one step split on the card's clock and one exchange run again on CPU
    copies. Returns numpy and Python values only."""
    import hashlib

    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.comm import allreduce
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.models import resnet50

    net = resnet50(num_classes=1000)
    shape = (BATCH,) + IMAGE
    # each rank draws its own weights: rank 0's must reach every rank
    args, aux = random_params(net, SEED + rank, data=shape)
    rng = np.random.default_rng(SEED + 6)
    X = rng.standard_normal((world * BATCH,) + shape[1:], np.float32)
    Y = rng.integers(0, 1000, world * BATCH).astype(np.float32)
    X, Y = X[rank * BATCH:(rank + 1) * BATCH], Y[rank * BATCH:(rank + 1) * BATCH]
    # one fixed batch a rank every step: the run overfits it
    Xs = np.ascontiguousarray(np.broadcast_to(
        X, (DP_STEPS,) + shape).reshape((-1,) + shape[1:]))
    Ys = np.tile(Y, DP_STEPS)

    def digest(*dicts):
        h = hashlib.sha256()
        for d in dicts:
            for k in sorted(d):
                v = d[k]
                v = v.numpy() if isinstance(v, torch.Tensor) else v
                h.update(np.ascontiguousarray(v).tobytes())
        return h.hexdigest()

    sent, wire = [], allreduce._wire

    def counting_wire(op, out, inp, group):
        sent.append((op, inp.numel() * inp.element_size()))
        return wire(op, out, inp, group)

    kernels = {k.__name__: k for k in ck.KERNELS}
    kernels["fused_adam"] = kfa.fused_adam
    metric, stamps = step_loss_metric(mt), []
    comm.reset_comm_stats()
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=LEARNING_RATE,
                           arg_params=args, aux_params=aux)
    torch.cuda.synchronize()
    allreduce._wire = counting_wire
    # the main path: every count is read around the fit
    for fn in kernels.values():
        fn.launches = 0
    model.fit(mt.io.NDArrayIter(Xs, Ys, batch_size=BATCH),
              kvstore="dist_sync", compression=mode, comm_kernels=True,
              eval_metric=metric,
              batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    launches = {n: fn.launches for n, fn in kernels.items()}
    allreduce._wire = wire
    by_op = {}
    for op, nbytes in sent:
        by_op[op] = by_op.get(op, 0) + nbytes
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    out = {"launches": launches, "losses": list(metric.steps),
           "step_ms": step_ms, "wire_bytes_by_op": by_op,
           "init_digest": digest(args, aux),
           "digest": digest(model.arg_params, model.aux_params),
           "finite": all(bool(torch.isfinite(v).all())
                         for v in model.arg_params.values()),
           "comm_stats_wire_bytes": comm.comm_stats()["wire_bytes"]}

    # one step split on the card's clock, in 3 more steps after the fit with
    # synchronizes added: a barrier before the sync (the wait for the peer
    # rank, host clock); inside the sync the kernels (CUDA events around each
    # launch), the copies to and from pinned host buffers (host clock, card
    # synchronized around each) and the gloo calls (host clock)
    state, sync = model._train_state, model._train_state.grad_sync
    arrays = {"data": torch.from_numpy(X).cuda(),
              "softmax_label": torch.from_numpy(Y).cuda()}
    kernel_events, host_s = [], {}
    originals = {n: getattr(ck, n) for n in (k.__name__ for k in ck.KERNELS)}
    hosts = {"_to_host": "sync_d2h_ms", "_wire": "sync_gloo_ms",
             "_to_card": "sync_h2d_ms"}
    host_fns = {n: getattr(allreduce, n) for n in hosts}

    def timed_kernel(fn):
        # wraps copies ``launches``: the wrapper's own count takes the adds
        @functools.wraps(fn)
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            result = fn(*a, **kw)
            ev[1].record()
            kernel_events.append(ev)
            return result
        return run

    def timed_host(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            host_s[key] += time.perf_counter() - t0
            return result
        return run

    split = {k: [] for k in ("forward_ms", "backward_ms", "peer_wait_ms",
                             "sync_ms", "update_ms", "sync_kernels_ms",
                             *hosts.values())}
    for name, fn in originals.items():
        setattr(ck, name, timed_kernel(fn))
    for name, key in hosts.items():
        setattr(allreduce, name, timed_host(host_fns[name], key))
    try:
        for _ in range(3):
            kernel_events.clear()
            host_s.update({k: 0.0 for k in hosts.values()})
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            state.forward(arrays)
            ev[1].record()
            state.backward()
            ev[2].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier()
            split["peer_wait_ms"].append((time.perf_counter() - t0) * 1e3)
            ev[3].record()
            state.sync()
            ev[4].record()
            state.update(LEARNING_RATE)
            ev[5].record()
            torch.cuda.synchronize()
            for key, (a, b) in (("forward_ms", ev[0:2]),
                                ("backward_ms", ev[1:3]),
                                ("sync_ms", ev[3:5]), ("update_ms", ev[4:6])):
                split[key].append(a.elapsed_time(b))
            split["sync_kernels_ms"].append(
                sum(a.elapsed_time(b) for a, b in kernel_events))
            for key, seconds in host_s.items():
                split[key].append(seconds * 1e3)
    finally:
        for name, fn in originals.items():
            setattr(ck, name, fn)
        for name, fn in host_fns.items():
            setattr(allreduce, name, fn)
    out["split"] = {k: statistics.median(v) for k, v in split.items()}

    # the same exchange on CPU copies of this step's gradients and residual:
    # the kernels' plain versions and the gloo exchange of CPU tensors
    state.forward(arrays)
    state.backward()
    grads_cpu = {k: g.detach().cpu() for k, g in state.grads.items()}
    resid_cpu = None if sync.residual is None else sync.residual.cpu()
    state.sync()
    card = ({k: g.detach().cpu() for k, g in state.grads.items()},
            None if sync.residual is None else sync.residual.cpu())
    host = comm.error_feedback_allreduce(
        grads_cpu, resid_cpu, sync.spec, axis_size=world, average=False,
        kernels=sync.kernels)
    state.update(LEARNING_RATE)
    out["card_vs_cpu_sync_bitwise"] = (
        all(bits_equal(torch, card[0][k], host[0][k]) for k in card[0])
        and (card[1] is None or bits_equal(torch, card[1], host[1])))
    out["residual_abs_max"] = float(card[1].abs().max())
    del model, state, sync, arrays
    torch.cuda.empty_cache()
    return out


def dp_rank(rank, world, init_method, queue):
    """A rank process of dp_train: joins the gloo group and reports to the
    parent through ``queue``; it prints nothing."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.set_num_threads(4)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        results = {mode: dp_train_rank(torch, rank, world, mode)
                   for mode in DP_MODES}
        queue.put((rank, True, results))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_dp_ranks(torch):
    """Start the dp_train ranks (spawn), collect their results; a rank that
    fails or a run past the time limit kills every rank and raises."""
    import multiprocessing as mp
    import os
    import queue as queue_mod
    from pathlib import Path

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rdv_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    rdv_dir.mkdir(parents=True, exist_ok=True)
    rdv = rdv_dir / f"rendezvous-{os.getpid()}"
    if rdv.exists():
        rdv.unlink()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=dp_rank, daemon=True,
                         args=(rank, DP_WORLD, f"file://{rdv}", queue))
             for rank in range(DP_WORLD)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + DP_TIMEOUT_S
    try:
        while len(results) < DP_WORLD:
            left = deadline - time.monotonic()
            require(left > 0, f"dp_train ranks finished in {DP_TIMEOUT_S} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                require(not dead, f"dp_train rank(s) {dead} died")
                continue
            require(ok, f"dp_train rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if rdv.exists():
            rdv.unlink()
    return [results[r] for r in range(DP_WORLD)]


def phase_dp_train(torch, comm):
    """ResNet-50 trained data-parallel on two ranks that share the card,
    int8 and twobit, through the comm kernels; checks and the time split."""
    ranks = run_dp_ranks(torch)
    launches = {}
    for mode in DP_MODES:
        per_step = DP_LAUNCHES[mode]
        plan = comm.allreduce_plan(RESNET50_GRAD, DP_WORLD, mode)
        rows = {r["op"]: r for r in plan["collectives"]}
        for rank, res in enumerate(ranks):
            got = res[mode]
            for name, count in got["launches"].items():
                want = per_step.get(name, 0) * DP_STEPS
                require(count == want,
                        f"dp_train {mode} rank {rank}: {name} launched "
                        f"{count} times in {DP_STEPS} steps, expected {want}")
            by_op = got["wire_bytes_by_op"]
            require(by_op.get("all_to_all", 0) == DP_STEPS
                    * rows["all-to-all"]["payload_bytes"]
                    and by_op.get("all_gather", 0) * DP_WORLD == DP_STEPS
                    * rows["all-gather"]["payload_bytes"],
                    f"dp_train {mode} rank {rank}: wire bytes {by_op} against "
                    f"the plan {rows}")
            require(got["comm_stats_wire_bytes"] ==
                    DP_STEPS * plan["wire_bytes"],
                    f"dp_train {mode}: comm_stats against the plan")
            losses = got["losses"]
            require(len(losses) == DP_STEPS and np.isfinite(losses).all()
                    and losses[-1] < losses[0],
                    f"dp_train {mode} rank {rank}: the loss of its fixed "
                    f"batch fell: {losses}")
            require(got["finite"], f"dp_train {mode} rank {rank}: finite "
                    "parameters")
            require(got["card_vs_cpu_sync_bitwise"],
                    f"dp_train {mode} rank {rank}: the card's sync equals "
                    "the CPU's bitwise")
        require(len({r[mode]["digest"] for r in ranks}) == 1,
                f"dp_train {mode}: both ranks' parameters are bitwise equal")
        require(len({r[mode]["init_digest"] for r in ranks}) == DP_WORLD,
                "dp_train: the ranks drew different initial weights, so "
                "equal parameters show rank 0's broadcast")
        r0 = ranks[0][mode]
        median_ms = statistics.median(r0["step_ms"])
        wire_per_step = (DP_WORLD - 1) / DP_WORLD * (
            r0["wire_bytes_by_op"]["all_to_all"]
            + DP_WORLD * r0["wire_bytes_by_op"]["all_gather"]) / DP_STEPS
        emit({"phase": "dp_train", "mode": mode, "model": "resnet50",
              "world": DP_WORLD, "batch_per_rank": BATCH,
              "global_batch": DP_WORLD * BATCH, "steps": DP_STEPS,
              "optimizer": "adam", "fused": True, "comm_kernels": True,
              "transport": "gloo through pinned host buffers, both ranks "
                           "on one card",
              "launches": r0["launches"], "launches_per_step": DP_LAUNCHES[mode],
              "wire_bytes_per_step": wire_per_step,
              "plan_wire_bytes_per_step": plan["wire_bytes"],
              "fp32_wire_bytes_per_step": plan["fp32_wire_bytes"],
              "params_bitwise_equal_across_ranks": True,
              "card_vs_cpu_sync_bitwise": True,
              "residual_abs_max": r0["residual_abs_max"],
              "losses_rank0": r0["losses"],
              "losses_rank1": ranks[1][mode]["losses"],
              "step_ms": r0["step_ms"], "step_ms_median": median_ms,
              "global_images_per_s": DP_WORLD * BATCH * 1e3 / median_ms,
              "split_rank0": r0["split"],
              "split_rank1": ranks[1][mode]["split"]})
        for name, count in r0["launches"].items():
            if name != "fused_adam" and DP_LAUNCHES[mode].get(name):
                launches[name] = count
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.kernels import _common as common
    from mxnet_tpu_torch.kernels import comm_kernels as ck
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import int8_matmul as k8
    from mxnet_tpu_torch.kernels import registry

    smi = phase_card(torch, common)
    rows, max_err = phase_kernels(torch, k8, registry)
    launches = phase_slice(torch, mt, k8)
    adam_row, adam_err = phase_fused_adam(torch, topt, kfa, registry)
    launches.update(phase_train(torch, mt, kfa))
    flash_rows, flash_errs = phase_flash(torch, tfa, registry)
    serve_launches, lm_params, lm_grad_errs = phase_lm_serve(torch, mt, tfa)
    train_launches = phase_lm_train(torch, mt, topt, tfa, kfa, lm_params,
                                    lm_grad_errs)
    require(serve_launches["flash_fwd"] > 0, "the LM forward ran flash_fwd")
    launches.update({n: train_launches[n] for n in flash_rows})
    comm_rows_, comm_phase_launches = phase_comm_kernels(torch, ck, comm,
                                                         registry)
    launches.update(phase_dp_train(torch, comm))
    # not on fit's path: twobit gathers in bf16 (comm/allreduce.py)
    launches["dequant_twobit"] = 0
    require(not any(m.split(".")[0] in ("jax", "mxnet_tpu")
                    for m in sys.modules), "the run imported JAX")

    main_row = next(r for r in rows if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
    kernels = []
    for name, err, row, library_ms in (
            ("int8_matmul", max_err, main_row, main_row["int_mm_ms"]),
            ("fused_adam", adam_err, adam_row, adam_row["library_ms"]),
            *((n, flash_errs[n], r, r["library_ms"])
              for n, r in flash_rows.items()),
            # bitwise equal to their plain versions: no error
            *((n, 0.0, r, r["library_ms"]) for n, r in comm_rows_.items())):
        spec = registry.get_kernel(name)
        kernels.append({
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms})
        if name == "dequant_twobit":
            kernels[-1]["comm_kernels_phase_launches"] = \
                comm_phase_launches[name]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
