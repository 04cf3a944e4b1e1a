"""Memory under four strategies, the port's counterpart of
``examples/memcost/``."""
