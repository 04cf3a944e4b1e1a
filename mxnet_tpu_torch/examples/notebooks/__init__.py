"""The notebook-style walkthroughs, the port's counterparts of
``examples/notebooks/``."""
