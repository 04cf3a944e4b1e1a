"""AlexNet, with LRN after the first two convolutions and Dropout in the
classifier.

Counterpart of ``mxnet_tpu/models/alexnet.py``: the same Symbol builder, so
the same node names, parameter shapes and serialised graph."""

from .. import symbol as sym


def alexnet(num_classes=1000):
    data = sym.Variable("data")
    # stage 1
    conv1 = sym.Convolution(data=data, name="conv1", kernel=(11, 11),
                            stride=(4, 4), num_filter=96)
    relu1 = sym.Activation(data=conv1, name="relu1", act_type="relu")
    lrn1 = sym.LRN(data=relu1, name="norm1", nsize=5, alpha=1e-4, beta=0.75, knorm=2)
    pool1 = sym.Pooling(data=lrn1, name="pool1", kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # stage 2
    conv2 = sym.Convolution(data=pool1, name="conv2", kernel=(5, 5), pad=(2, 2),
                            num_filter=256)
    relu2 = sym.Activation(data=conv2, name="relu2", act_type="relu")
    lrn2 = sym.LRN(data=relu2, name="norm2", nsize=5, alpha=1e-4, beta=0.75, knorm=2)
    pool2 = sym.Pooling(data=lrn2, name="pool2", kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # stage 3
    conv3 = sym.Convolution(data=pool2, name="conv3", kernel=(3, 3), pad=(1, 1),
                            num_filter=384)
    relu3 = sym.Activation(data=conv3, name="relu3", act_type="relu")
    conv4 = sym.Convolution(data=relu3, name="conv4", kernel=(3, 3), pad=(1, 1),
                            num_filter=384)
    relu4 = sym.Activation(data=conv4, name="relu4", act_type="relu")
    conv5 = sym.Convolution(data=relu4, name="conv5", kernel=(3, 3), pad=(1, 1),
                            num_filter=256)
    relu5 = sym.Activation(data=conv5, name="relu5", act_type="relu")
    pool3 = sym.Pooling(data=relu5, name="pool3", kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # classifier
    flatten = sym.Flatten(data=pool3, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, name="fc1", num_hidden=4096)
    relu6 = sym.Activation(data=fc1, name="relu6", act_type="relu")
    drop1 = sym.Dropout(data=relu6, name="drop1", p=0.5)
    fc2 = sym.FullyConnected(data=drop1, name="fc2", num_hidden=4096)
    relu7 = sym.Activation(data=fc2, name="relu7", act_type="relu")
    drop2 = sym.Dropout(data=relu7, name="drop2", p=0.5)
    fc3 = sym.FullyConnected(data=drop2, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc3, name="softmax")
