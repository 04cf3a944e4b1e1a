"""Analysis tools of the port. This slice brings the runtime lock-order
watchdog (:mod:`.lockwatch`); the rest of the JAX package's ``analysis/``
(graph passes, source lint, the jaxpr audit, the sharding audit) is a
later item (ROADMAP A7)."""

from . import lockwatch  # noqa: F401

__all__ = ["lockwatch"]
