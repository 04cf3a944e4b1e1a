"""Inception-BN, the CIFAR-10 net and the ImageNet one.

Counterpart of ``mxnet_tpu/models/inception.py``: the same Symbol builders,
so the same node names, parameter shapes and serialised graph. ``layout``
"NCHW" or "NHWC" sets the activation layout (Concat and BatchNorm follow
the channel axis); weights are OIHW either way.
"""

from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None, layout="NCHW"):
    conv = sym.Convolution(data=data, name=f"conv_{name}", kernel=kernel,
                           stride=stride, pad=pad, num_filter=num_filter,
                           layout=layout)
    bn = sym.BatchNorm(data=conv, name=f"bn_{name}",
                       axis=3 if layout == "NHWC" else 1)
    return sym.Activation(data=bn, name=f"relu_{name}", act_type="relu")


def _inception_unit(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3, pool,
                    proj, name, layout="NCHW"):
    # 3x3 branch
    c3r = _conv_factory(data, num_3x3red, (1, 1), name=f"{name}_3x3r",
                        layout=layout)
    c3 = _conv_factory(c3r, num_3x3, (3, 3), pad=(1, 1), name=f"{name}_3x3",
                       layout=layout)
    # double 3x3 branch
    cd3r = _conv_factory(data, num_d3x3red, (1, 1), name=f"{name}_d3x3r",
                         layout=layout)
    cd3a = _conv_factory(cd3r, num_d3x3, (3, 3), pad=(1, 1),
                         name=f"{name}_d3x3a", layout=layout)
    cd3b = _conv_factory(cd3a, num_d3x3, (3, 3), pad=(1, 1),
                         name=f"{name}_d3x3b", layout=layout)
    branches = [c3, cd3b]
    if proj > 0:
        p = sym.Pooling(data=data, name=f"{name}_pool", kernel=(3, 3),
                        stride=(1, 1), pad=(1, 1), pool_type=pool,
                        layout=layout)
        pp = _conv_factory(p, proj, (1, 1), name=f"{name}_proj",
                           layout=layout)
        branches.append(pp)
    return sym.Concat(*branches, name=f"{name}_concat",
                      dim=3 if layout == "NHWC" else 1)


def _downsample_unit(data, num_3x3red, num_3x3, name, layout="NCHW"):
    c3r = _conv_factory(data, num_3x3red, (1, 1), name=f"{name}_3x3r",
                        layout=layout)
    c3 = _conv_factory(c3r, num_3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name=f"{name}_3x3", layout=layout)
    pool = sym.Pooling(data=data, name=f"{name}_pool", kernel=(3, 3),
                       stride=(2, 2), pad=(1, 1), pool_type="max",
                       layout=layout)
    return sym.Concat(c3, pool, name=f"{name}_concat",
                      dim=3 if layout == "NHWC" else 1)


def inception_bn_cifar(num_classes=10, layout="NCHW"):
    """The CIFAR-10 inception net (reference: example/cifar10 — 28x28/32x32
    inputs, three inception stages)."""
    data = sym.Variable("data")
    c1 = _conv_factory(data, 96, (3, 3), pad=(1, 1), name="1", layout=layout)
    in3a = _inception_unit(c1, 32, 32, 32, 32, "avg", 32, "3a", layout)
    in3b = _inception_unit(in3a, 32, 32, 32, 48, "avg", 48, "3b", layout)
    in3c = _downsample_unit(in3b, 32, 80, "3c", layout)
    in4a = _inception_unit(in3c, 64, 112, 32, 48, "avg", 64, "4a", layout)
    in4b = _inception_unit(in4a, 64, 96, 32, 64, "avg", 64, "4b", layout)
    in4c = _inception_unit(in4b, 64, 80, 32, 80, "avg", 64, "4c", layout)
    in4d = _inception_unit(in4c, 64, 96, 32, 96, "avg", 64, "4d", layout)
    in4e = _downsample_unit(in4d, 64, 96, "4e", layout)
    in5a = _inception_unit(in4e, 96, 176, 32, 96, "avg", 96, "5a", layout)
    in5b = _inception_unit(in5a, 96, 176, 32, 96, "max", 96, "5b", layout)
    pool = sym.Pooling(data=in5b, name="global_pool", kernel=(7, 7),
                       pool_type="avg", global_pool=True, layout=layout)
    flatten = sym.Flatten(data=pool, name="flatten")
    fc = sym.FullyConnected(data=flatten, name="fc", num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc, name="softmax")


def inception_bn(num_classes=1000, layout="NCHW"):
    """ImageNet Inception-BN (reference: example/imagenet/inception-bn.py)."""
    data = sym.Variable("data")
    # stem
    c1 = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                       name="stem1", layout=layout)
    p1 = sym.Pooling(data=c1, name="stem_pool1", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1), pool_type="max", layout=layout)
    c2r = _conv_factory(p1, 64, (1, 1), name="stem2r", layout=layout)
    c2 = _conv_factory(c2r, 192, (3, 3), pad=(1, 1), name="stem2",
                       layout=layout)
    p2 = sym.Pooling(data=c2, name="stem_pool2", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1), pool_type="max", layout=layout)
    in3a = _inception_unit(p2, 64, 64, 64, 96, "avg", 32, "3a", layout)
    in3b = _inception_unit(in3a, 64, 96, 64, 96, "avg", 64, "3b", layout)
    in3c = _downsample_unit(in3b, 128, 160, "3c", layout)
    in4a = _inception_unit(in3c, 64, 96, 96, 128, "avg", 128, "4a", layout)
    in4b = _inception_unit(in4a, 96, 128, 96, 128, "avg", 128, "4b", layout)
    in4c = _inception_unit(in4b, 128, 160, 128, 160, "avg", 128, "4c", layout)
    in4d = _inception_unit(in4c, 96, 192, 160, 192, "avg", 128, "4d", layout)
    in4e = _downsample_unit(in4d, 128, 192, "4e", layout)
    in5a = _inception_unit(in4e, 176, 320, 160, 224, "avg", 128, "5a", layout)
    in5b = _inception_unit(in5a, 176, 320, 160, 224, "max", 128, "5b", layout)
    pool = sym.Pooling(data=in5b, name="global_pool", kernel=(7, 7),
                       pool_type="avg", global_pool=True, layout=layout)
    flatten = sym.Flatten(data=pool, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, name="fc1", num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc1, name="softmax")
