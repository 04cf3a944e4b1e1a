"""Caffe → mxnet_tpu_torch converter, the port's counterpart of
``tools/caffe_converter/``.

Dependency-free as the JAX package's: ``prototxt.py`` is the port's own copy
of the protobuf text-format parser, ``convert_symbol`` maps parsed layers
onto the port's Symbol API, and ``convert_model`` loads weights from an
``.npz`` blob dump (or, where a caffe installation is present, from a
``.caffemodel``) and writes a checkpoint pair that either package's
``FeedForward.load`` reads. The two CLIs:

    python -m mxnet_tpu_torch.tools.caffe_converter.convert_symbol \\
        net.prototxt net-symbol.json
    python -m mxnet_tpu_torch.tools.caffe_converter.convert_model \\
        net.prototxt blobs.npz prefix
"""

from .convert_model import (convert_weights, dump_caffemodel_npz,
                            load_caffemodel_blobs, load_npz_blobs)
from .convert_symbol import proto_to_symbol

__all__ = ["proto_to_symbol", "convert_weights", "load_npz_blobs",
           "load_caffemodel_blobs", "dump_caffemodel_npz"]
