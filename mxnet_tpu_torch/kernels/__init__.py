"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing a kernel module builds nothing: a CUDA source is compiled at its
first launch (see ``_common.py``). Importing this package registers every
kernel's cost model.
"""

from . import flash_attention, fused_adam, int8_matmul  # noqa: F401
