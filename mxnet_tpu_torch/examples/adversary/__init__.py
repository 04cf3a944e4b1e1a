"""Adversarial examples, the port's counterpart of ``examples/adversary/``."""
