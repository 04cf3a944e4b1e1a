"""MNIST training, the port's counterpart of ``examples/mnist/``."""
