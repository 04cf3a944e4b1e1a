"""Resilience: the asynchronous checkpoint plane (:mod:`.ckpt_async`).

Counterpart of ``mxnet_tpu/resilience/``; its other modules (guards,
preemption, elastic training, the chaos sites) are later items of the
port."""
