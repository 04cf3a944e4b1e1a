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
6. prints one line ``{"kernels": [...]}`` with each kernel's launches on its
   main path, error, times and bound;
7. ends with ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line. Without CUDA it exits non-zero at once. It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
BATCH = 32
REQUESTS = 8
# (M, K, N): ResNet-50 fc1 at batch 32 and at batch 1, the JAX package's own
# ragged test shape, and a large square-ish product
KERNEL_SHAPES = ((32, 2048, 1000), (1, 2048, 1000), (37, 100, 23),
                 (256, 4096, 4096))
MAIN_SHAPE = KERNEL_SHAPES[0]
KERNEL_SOURCES = ("int8_matmul", "fused_adam")
TRAIN_STEPS = 8
LEARNING_RATE = 1e-3
# tests/test_pallas_kernels.py:259, the JAX package's own odd leaf set
ODD_SHAPES = {"w1": (64, 33), "b1": (33,), "w2": (7, 5), "s": ()}


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
    # nvcc on a fresh checkout: one compiler per source, all at once
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(common.load_library, KERNEL_SOURCES))
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_loaded": list(KERNEL_SOURCES), "build_s": build_s})
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


def phase_train(torch, mt, kfa):
    """Full-width ResNet-50 trained through FeedForward.fit on the card."""
    from mxnet_tpu_torch.convert import random_params
    from mxnet_tpu_torch.models import resnet50
    from mxnet_tpu_torch.ops import OPS

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
    head = OPS.create("SoftmaxOutput")

    class StepLoss(mt.metric.EvalMetric):
        """SoftmaxOutput.loss_value of each step's training outputs, per
        image; reading it syncs the host with the step."""

        def __init__(self):
            super().__init__("softmax_loss")
            self.steps = []

        def update(self, labels, preds):
            value = float(head.loss_value(preds[0], labels[0])) / BATCH
            self.steps.append(value)
            self.sum_metric += value
            self.num_inst += 1

    metric, stamps = StepLoss(), []
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import _common as common
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import int8_matmul as k8
    from mxnet_tpu_torch.kernels import registry

    smi = phase_card(torch, common)
    rows, max_err = phase_kernels(torch, k8, registry)
    launches = phase_slice(torch, mt, k8)
    adam_row, adam_err = phase_fused_adam(torch, topt, kfa, registry)
    launches.update(phase_train(torch, mt, kfa))
    require(not any(m.split(".")[0] in ("jax", "mxnet_tpu")
                    for m in sys.modules), "the run imported JAX")

    main_row = next(r for r in rows if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
    kernels = []
    for name, err, row, library_ms in (
            ("int8_matmul", max_err, main_row, main_row["int_mm_ms"]),
            ("fused_adam", adam_err, adam_row, adam_row["library_ms"])):
        spec = registry.get_kernel(name)
        kernels.append({
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library_ms})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
