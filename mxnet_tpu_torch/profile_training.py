"""Where a training step's device time goes, by kernel, on one CUDA card.

    python3 -m mxnet_tpu_torch.profile_training [--model resnet50|transformer]

``resnet50`` trains the seeded full-width ResNet-50 of ``chip_smoke.py``
(batch 32, seed 0, Adam with the fused step, lr 1e-3) for two steps through
``FeedForward(ctx=gpu(0))``, then traces three more steps of the same
training state (forward, backward, update). ``transformer`` takes the
full-width transformer LM of ``chip_smoke.py`` (bf16, batch 8 x 2048 tokens,
seed 0) through two steps of ``make_train_step`` with the fused Adam step,
then traces three more. Either prints one JSON object: the card's name and
power limit, wall and device time per step, the device's idle share of the
window, and the kernels with the most device time. TF32 is off, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import FeedForward, gpu, io
from . import optimizer as opt_mod
from .convert import random_params
from .models import TransformerLM, resnet50, transformer_lm_config
from .profile_serving import device_report

BATCH = 32     # chip_smoke.py's training batch
SEED = 0       # and its weight seed
STEPS = 3
LEARNING_RATE = 1e-3
LM_BATCH, LM_SEQ = 8, 2048   # chip_smoke.py's transformer batch


def resnet_step(ctx):
    net = resnet50(num_classes=1000)
    shape = (BATCH, 3, 224, 224)
    arg_params, aux_params = random_params(net, SEED, data=shape)
    rng = np.random.default_rng(SEED + 2)
    images = rng.standard_normal(shape, np.float32)
    labels = rng.integers(0, 1000, BATCH).astype(np.float32)
    model = FeedForward(net, ctx=ctx, num_epoch=1, optimizer="adam",
                        fused=True, learning_rate=LEARNING_RATE,
                        arg_params=arg_params, aux_params=aux_params)
    model.fit(io.NDArrayIter(np.concatenate([images, images]),
                             np.concatenate([labels, labels]),
                             batch_size=BATCH))
    state = model._train_state
    batch = {"data": torch.from_numpy(images).to(ctx.torch_device),
             "softmax_label": torch.from_numpy(labels).to(ctx.torch_device)}

    def step():
        state.forward(batch)
        state.backward()
        state.update(LEARNING_RATE)

    return step, {"batch": BATCH}


def transformer_step(ctx):
    cfg = transformer_lm_config()
    model = TransformerLM(cfg)
    opt = opt_mod.create("adam", learning_rate=LEARNING_RATE, fused=True)
    params, state = model.init_sharded(None, seed=SEED, optimizer=opt,
                                       ctx=ctx)
    rng = np.random.default_rng(SEED + 4)
    tokens, targets = (
        torch.from_numpy(rng.integers(0, cfg["vocab_size"], (LM_BATCH, LM_SEQ)))
        .to(ctx.torch_device) for _ in range(2))
    train_step = model.make_train_step(None, optimizer=opt)
    carry = [params, state]

    def step():
        carry[0], carry[1], loss = train_step(*carry, tokens, targets)
        return loss

    for _ in range(2):
        float(step())
    return step, {"batch": LM_BATCH, "seq": LM_SEQ}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("resnet50", "transformer"),
                    default="resnet50")
    args = ap.parse_args(argv)
    ctx = gpu(0)  # raises without CUDA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = resnet_step if args.model == "resnet50" else transformer_step
    step, shape = build(ctx)
    report = device_report(step, STEPS, "step")
    print(json.dumps({"model": args.model, **shape, "optimizer": "adam",
                      "fused": True, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
