"""A numpy operator as a network head, the port's counterpart of
``examples/numpy_ops/``."""
