"""The launched multi-process tiers, the port's counterparts of
``examples/distributed/``. Every script runs under the repo's launcher:

    python tools/launch.py -n <N> python -m \\
        mxnet_tpu_torch.examples.distributed.<script> [--cpu]

``crash_resume_train`` and ``elastic_train`` run in one process, with a
checkpoint directory as their argument.
"""
