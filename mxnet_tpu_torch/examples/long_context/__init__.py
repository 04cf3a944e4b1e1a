"""Long-context LM training over a sequence-parallel mesh of ranks, the
port's counterpart of ``examples/long_context/``."""
