"""The framework walkthrough, the port's counterpart of
``examples/python_howto/``."""
