"""Thin wrapper over ``python -m mxnet_tpu_torch.analysis`` (mxlint): the
port's counterpart of ``tools/run_mxlint.py``, with its argument handling
and exit codes (0 clean, 1 on an error-severity finding, 2 on a bad path, 3
on new violations against ``--baseline``).

With no paths it lints the port's package, ``mxnet_tpu_torch``, which
holds the port's tools and examples too: the tree the tier-1 self-lint
covers (``tests/test_torch_mxlint.py``). It does not lint the port's tests:
they import JAX and the JAX package to hold the port against them, which
MX101 refuses in the port's code. Every other argument passes through:

    python -m mxnet_tpu_torch.tools.run_mxlint              # the package
    python -m mxnet_tpu_torch.tools.run_mxlint some/file.py # any paths
"""

import os
import sys

from ..analysis import main
from ..analysis.__main__ import _parser

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(argv) -> int:
    argv = list(argv)
    # the real parser decides whether positional paths were given: a naive
    # "starts with -" scan misreads flag values like --select MX101
    if not _parser().parse_args(argv).paths:
        argv = [PACKAGE] + argv
    return main(argv)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
