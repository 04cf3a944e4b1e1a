"""LeNet-5 style convnet.

Counterpart of ``mxnet_tpu/models/lenet.py``: the same Symbol builder, so
the same node names, parameter shapes and serialised graph."""

from .. import symbol as sym


def lenet(num_classes=10):
    data = sym.Variable("data")
    conv1 = sym.Convolution(data=data, name="conv1", kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(data=conv1, name="tanh1", act_type="tanh")
    pool1 = sym.Pooling(data=tanh1, name="pool1", pool_type="max",
                        kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(data=pool1, name="conv2", kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(data=conv2, name="tanh2", act_type="tanh")
    pool2 = sym.Pooling(data=tanh2, name="pool2", pool_type="max",
                        kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(data=pool2, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, name="fc1", num_hidden=500)
    tanh3 = sym.Activation(data=fc1, name="tanh3", act_type="tanh")
    fc2 = sym.FullyConnected(data=tanh3, name="fc2", num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc2, name="softmax")
