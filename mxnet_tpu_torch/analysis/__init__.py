"""Analysis passes of the port (counterpart of ``mxnet_tpu/analysis/``).

  Pass 2  graph verification (:mod:`.graph`) — ``Symbol.verify()``: shape
          and dtype inference over the node DAG plus structural checks
          (MX401-MX406), run on every bind (``MXNET_TPU_VERIFY=0`` turns
          it off).
  Pass 3  the program audit (:mod:`.program_audit`, the counterpart of
          ``jaxpr_audit.py``) — one eager step under a dispatch mode: host
          round trips (MX501), dtype promotions (MX502) and per-operation
          FLOP/byte rows.
  Pass 5  the sharding audit (:mod:`.sharding`) — a data-parallel step's
          collectives reconciled against the comm layer's closed-form
          plan (MX802), over compiled HLO text or one profiled step of the
          port, and partition-spec sanity over the port's mesh (MX804);
          behind ``fit/precompile(shard_audit=)`` and
          ``MXNET_TPU_SHARD_AUDIT``.

Every check reports through the rule registry (:mod:`.rules`, the JAX
package's ids). :mod:`.lockwatch` is the runtime lock-order watchdog. The
source passes (Pass 1's lint, Pass 4's concurrency lint) and the command
line come with ROADMAP A item 7's source passes: their names raise
``NotImplementedError`` until then. ``audit_jaxpr`` and
``audit_jaxpr_sharding`` read a jaxpr and have no counterpart here
(ROADMAP C.2): ``audit_program`` and ``audit_step_program`` take their
place.
"""

from . import lockwatch
from .graph import verify_json, verify_json_file, verify_symbol
from .rules import RULES, Finding, Rule, get_rule, register_rule

__all__ = [
    "RULES", "Finding", "Rule", "get_rule", "register_rule",
    "lint_file", "lint_paths", "lint_source",
    "verify_json", "verify_json_file", "verify_symbol",
    "audit_executor", "audit_program", "cost_rows", "main",
    "lockwatch", "concurrency_lint_paths", "concurrency_lint_source",
    "audit_step_program", "audit_collective_drift", "check_partition_specs",
    "expected_collectives", "selfcheck_report", "shard_audit_enabled",
]

_SOURCE_PASSES = "ROADMAP A7 (analysis/ source passes and the CLI)"


def _later(name):
    def later(*args, **kwargs):
        raise NotImplementedError(
            f"analysis.{name} is not ported yet: {_SOURCE_PASSES}")

    later.__name__ = name
    later.__doc__ = f"Not ported yet: {_SOURCE_PASSES}."
    return later


lint_file = _later("lint_file")
lint_paths = _later("lint_paths")
lint_source = _later("lint_source")
concurrency_lint_paths = _later("concurrency_lint_paths")
concurrency_lint_source = _later("concurrency_lint_source")
main = _later("main")


def audit_executor(*args, **kwargs):
    """Lazy re-export: the program audit pulls in the dispatch mode."""
    from .program_audit import audit_executor as impl

    return impl(*args, **kwargs)


def audit_program(*args, **kwargs):
    from .program_audit import audit_program as impl

    return impl(*args, **kwargs)


def cost_rows(*args, **kwargs):
    from .program_audit import cost_rows as impl

    return impl(*args, **kwargs)


def audit_step_program(*args, **kwargs):
    """Lazy re-export: the sharding audit pulls in the comm layer."""
    from .sharding import audit_step_program as impl

    return impl(*args, **kwargs)


def audit_collective_drift(*args, **kwargs):
    from .sharding import audit_collective_drift as impl

    return impl(*args, **kwargs)


def check_partition_specs(*args, **kwargs):
    from .sharding import check_partition_specs as impl

    return impl(*args, **kwargs)


def expected_collectives(*args, **kwargs):
    from .sharding import expected_collectives as impl

    return impl(*args, **kwargs)


def selfcheck_report(*args, **kwargs):
    from .sharding import selfcheck_report as impl

    return impl(*args, **kwargs)


def shard_audit_enabled(*args, **kwargs):
    from .sharding import shard_audit_enabled as impl

    return impl(*args, **kwargs)
