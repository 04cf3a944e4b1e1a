"""Where a training step's device time goes, by kernel, on one CUDA card.

    python3 -m mxnet_tpu_torch.profile_training

It trains the seeded full-width ResNet-50 of ``chip_smoke.py`` (batch 32,
seed 0, Adam with the fused step, lr 1e-3) for two steps through
``FeedForward(ctx=gpu(0))``, then traces three more steps of the same
training state (forward, backward, update) with ``torch.profiler`` and
prints one JSON object: the card's name and power limit, wall and device
time per step, the device's idle share of the window, and the kernels with
the most device time. TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import FeedForward, gpu, io
from .convert import random_params
from .models import resnet50
from .profile_serving import device_report

BATCH = 32     # chip_smoke.py's training batch
SEED = 0       # and its weight seed
STEPS = 3
LEARNING_RATE = 1e-3


def main(argv=None) -> int:
    del argv
    ctx = gpu(0)  # raises without CUDA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    report = device_report(step, STEPS, "step")
    print(json.dumps({"batch": BATCH, "optimizer": "adam", "fused": True,
                      **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
