"""Analysis passes of the port (counterpart of ``mxnet_tpu/analysis/``).

  Pass 1  source lint (:mod:`.source_lint`) — an AST walk over .py files:
          imports of JAX or the JAX package (MX101), hazards inside code
          captured into a CUDA graph (MX201-MX203, MX302, MX313), graphs
          re-captured per call (MX303), raw gradient collectives (MX304),
          un-barriered timing (MX306), and the layers' disciplines (spans,
          kernels, profiler, checkpoints, ledger, placement, robustness).
          Pure AST work: linted files are never imported or run.
  Pass 2  graph verification (:mod:`.graph`) — ``Symbol.verify()``: shape
          and dtype inference over the node DAG plus structural checks
          (MX401-MX406), run on every bind (``MXNET_TPU_VERIFY=0`` turns
          it off).
  Pass 3  the program audit (:mod:`.program_audit`, the counterpart of
          ``jaxpr_audit.py``) — one eager step under a dispatch mode: host
          round trips (MX501), dtype promotions (MX502) and per-operation
          FLOP/byte rows.
  Pass 4  concurrency (:mod:`.concurrency`) — a whole-package model of
          thread entry points and lock scopes: shared-state races
          (MX701), lock-order cycles (MX702), bare cv.wait (MX703), leaked
          non-daemon threads (MX704), fresh-lock locking (MX705). The
          runtime complement is the lock-order watchdog (:mod:`.lockwatch`,
          ``MXNET_TPU_LOCKWATCH``).
  Pass 5  the sharding audit (:mod:`.sharding`) — a data-parallel step's
          collectives reconciled against the comm layer's closed-form
          plan (MX802), over compiled HLO text or one profiled step of the
          port, and partition-spec sanity over the port's mesh (MX804);
          behind ``fit/precompile(shard_audit=)`` and
          ``MXNET_TPU_SHARD_AUDIT``; placement outside the owner layers
          (MX805) rides with Pass 1.

Every check reports through the rule registry (:mod:`.rules`, the JAX
package's ids). CLI: ``python -m mxnet_tpu_torch.analysis [paths]``
(``--concurrency``, ``--shardcheck``, ``--all``, ``--ci``,
``--baseline``; with no path it lints the port's tree, which tier-1 keeps
clean). Suppression: ``# mxlint: disable=MX306`` on the offending line, or
``# mxlint: skip-file`` in the first five lines. ``audit_jaxpr`` and
``audit_jaxpr_sharding`` read a jaxpr and have no counterpart here
(ROADMAP C.2): ``audit_program`` and ``audit_step_program`` take their
place.
"""

from . import lockwatch
from .graph import verify_json, verify_json_file, verify_symbol
from .rules import RULES, Finding, Rule, get_rule, register_rule
from .source_lint import lint_file, lint_paths, lint_source

__all__ = [
    "RULES", "Finding", "Rule", "get_rule", "register_rule",
    "lint_file", "lint_paths", "lint_source",
    "verify_json", "verify_json_file", "verify_symbol",
    "audit_executor", "audit_program", "cost_rows", "main",
    "lockwatch", "concurrency_lint_paths", "concurrency_lint_source",
    "audit_step_program", "audit_collective_drift", "check_partition_specs",
    "expected_collectives", "selfcheck_report", "shard_audit_enabled",
]


def concurrency_lint_paths(paths):
    """Pass 4 over a file set (lazy import keeps the package light)."""
    from . import concurrency

    return concurrency.lint_paths(paths)


def concurrency_lint_source(text, path="<string>"):
    from . import concurrency

    return concurrency.lint_source(text, path)


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


def main(argv=None) -> int:
    from .__main__ import main as impl

    return impl(argv)
