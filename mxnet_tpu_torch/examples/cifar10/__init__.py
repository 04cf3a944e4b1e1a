"""CIFAR-10 training, the port's counterpart of ``examples/cifar10/``."""
