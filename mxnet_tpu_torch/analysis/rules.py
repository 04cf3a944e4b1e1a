"""Rule registry and finding types of the analysis passes.

Counterpart of ``mxnet_tpu/analysis/rules.py``: every check of the port's
passes (the source lint, graph verification, the program audit, the
concurrency lint, the sharding audit) is a registered ``Rule`` with a
stable id, a severity and a fixit hint, under the JAX package's 41 ids and
severities, so a message, a pragma or a test can match on ``MX402`` in
either package. ``Finding.format()`` writes the JAX package's text.

Rule id bands:
  MX1xx  API compatibility (source pass)
  MX2xx  hazards inside captured code (source pass)
  MX3xx  re-capture and discipline risks (source pass)
  MX4xx  graph verifier (``Symbol.verify``, :mod:`.graph`)
  MX5xx  program audit (host round trips, dtype promotions,
         :mod:`.program_audit`)
  MX6xx  robustness (source pass)
  MX7xx  concurrency (:mod:`.concurrency`; :mod:`.lockwatch` is its
         runtime complement)
  MX8xx  sharding and collective audit (:mod:`.sharding`; MX805 rides
         with the source pass)

What a rule says of JAX and Pallas it says here of torch and CUDA
(:data:`TORCH_MEANING`): "traced" code is code captured into a CUDA graph
(the body of ``with torch.cuda.graph(...)``, the functions given to
``utils.compile.CapturedProgram`` / ``CapturedPair`` or
``torch.cuda.make_graphed_callables``, and what is nested in them), a
barrier is ``torch.cuda.synchronize`` or a host read of a tensor, a kernel
is a CUDA or Triton kernel of ``kernels/``, and MX101 forbids any import
of JAX or of the JAX package. :data:`JAX_ONLY` rules stay registered with
the JAX package's text and never fire over torch code. The other rules
(MX100, MX307, MX310, MX311, MX315, MX316, MX6xx, MX7xx and the runtime
passes' bands) keep the JAX package's text; four summaries leave out its
references to the JAX package's own change history.

Severities: ``error`` fails a pass (CLI exit 1) and makes
``Symbol.verify`` raise; ``warning`` is reported but non-fatal; ``info``
is advisory output.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Rule", "Finding", "RULES", "register_rule", "get_rule",
           "SEVERITIES", "TORCH_MEANING", "JAX_ONLY"]

SEVERITIES = ("error", "warning", "info")

# rules whose summary and fixit speak of torch and CUDA in the port
TORCH_MEANING = ("MX101", "MX201", "MX202", "MX203", "MX302", "MX303",
                 "MX304", "MX306", "MX309", "MX312", "MX313", "MX314",
                 "MX805")
# rules with no meaning over torch code: registered, never fired
JAX_ONLY = ("MX102", "MX301", "MX308")


@dataclass(frozen=True)
class Rule:
    """One static-analysis rule: stable id + severity + fixit hint."""

    id: str
    severity: str
    summary: str
    fixit: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.id}: bad severity {self.severity!r}")


RULES: dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str, summary: str,
                  fixit: str = "") -> Rule:
    """Register a rule under a stable id; re-registration must be identical
    (rules are contract surface — tests and suppression pragmas key on ids).
    """
    rule = Rule(rule_id, severity, summary, fixit)
    prev = RULES.get(rule_id)
    if prev is not None and prev != rule:
        raise ValueError(f"conflicting registration for rule {rule_id}")
    RULES[rule_id] = rule
    return rule


def get_rule(rule_id: str) -> Rule:
    return RULES[rule_id]


@dataclass
class Finding:
    """One diagnostic: a rule instance anchored to a location.

    ``path``/``line``/``col`` locate source findings; graph findings use
    ``node`` (op name + node name + input chain) instead and leave the
    location fields at their defaults.
    """

    rule: Rule
    message: str
    path: str = "<graph>"
    line: int = 0
    col: int = 0
    node: str = ""
    extra: dict = field(default_factory=dict)

    @property
    def is_error(self) -> bool:
        return self.rule.severity == "error"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        msg = f"{loc}: {self.rule.id} [{self.rule.severity}] {self.message}"
        if self.rule.fixit:
            msg += f"  (fix: {self.rule.fixit})"
        return msg

    def __str__(self):
        return self.format()


# -- the built-in catalog ------------------------------------------------------
# MX1xx — API compatibility (source pass; MX102 is JAX-only)
register_rule(
    "MX100", "error",
    "file does not parse",
    "fix the syntax error; nothing else can be checked until it parses")
register_rule(
    "MX101", "error",
    "import of JAX or of the JAX package: the port imports torch, never "
    "jax, jaxlib or mxnet_tpu (not even a module there that does not "
    "import JAX)",
    "keep a copy of what the port needs inside mxnet_tpu_torch; only the "
    "tests import both packages")
register_rule(
    "MX102", "warning",
    "deprecated JAX API path (works today, scheduled for removal)",
    "migrate to the stable path or add a shim in mxnet_tpu.compat")

# MX2xx — hazards inside captured code (source pass)
register_rule(
    "MX201", "warning",
    "numpy call inside a captured function (runs once, on the host, at "
    "capture: its result is frozen into the CUDA graph and every replay "
    "reuses it)",
    "use torch operations on tensors inside the function given to "
    "CapturedProgram/CapturedPair or a torch.cuda.graph block; compute "
    "host values before the capture and pass them in a device tensor")
register_rule(
    "MX202", "error",
    "host synchronization inside a captured function",
    "remove .item()/.tolist()/.cpu()/.numpy()/float()/int() from captured "
    "code (a CUDA-graph capture forbids a sync: the capture raises); "
    "return the tensor and read it after the replay")
register_rule(
    "MX203", "warning",
    "Python control flow on a possibly-captured tensor",
    "use torch.where or masked arithmetic; a Python `if` on a tensor "
    "syncs, and the capture freezes the branch it took for every replay")

# MX3xx — re-capture and discipline risks (source pass; MX301 and MX308
# are JAX-only)
register_rule(
    "MX301", "warning",
    "non-hashable container for static argument",
    "pass a tuple: static args are jit-cache keys, and unhashable or "
    "freshly-rebuilt containers defeat or break the compile cache")
register_rule(
    "MX302", "warning",
    "string formatting inside a captured function",
    "move logging/formatting out of the captured function; an f-string "
    "on a tensor syncs, and any formatting runs once, at capture, never "
    "at a replay")
register_rule(
    "MX303", "warning",
    "CUDA graph re-captured per call: a CapturedProgram/CapturedPair/"
    "torch.cuda.CUDAGraph built per call or per loop iteration, so every "
    "invocation captures afresh and the graph's memory pool is rebuilt",
    "build the program once per program key and keep it (e.g. "
    "utils.compile.CapturedProgram stored on the instance or in a dict "
    "by key), then call or replay it")
register_rule(
    "MX304", "warning",
    "raw torch.distributed collective over gradients outside "
    "mxnet_tpu_torch.comm and parallel/ — full-precision, unbucketed, "
    "unaccounted gradient sync on the hot path (the comm subsystem owns "
    "that wire)",
    "route gradient allreduce through mxnet_tpu_torch.comm "
    "(compressed_allreduce / error_feedback_allreduce) or "
    "parallel.allreduce_grads, which add quantized wire formats, fused "
    "bucketing, and comm_stats() byte accounting")

register_rule(
    "MX307", "warning",
    "StepTimeline span or phase opened without a guaranteed close: a "
    "`begin_step(...)` result that is never `.end()`ed (or a "
    "`telemetry.phase()/timed()` context manager called but never "
    "entered) leaks an open span — later phases attach to a dead step "
    "and the cross-rank trace merge sees overlapping/unterminated spans",
    "close every span: `with tl.begin_step(...) as span:` (spans are "
    "context managers), or call `span.end()` on every exit path; use "
    "`with telemetry.phase(...)/timed(...):` — a bare call records "
    "nothing")

register_rule(
    "MX308", "warning",
    "wire collective in comm/ not pinned by optimization_barrier on both "
    "sides: converting before/after pure data movement is elementwise-"
    "equivalent, so XLA commutes the encode/decode casts across the "
    "collective and the payload crosses the wire at full precision — "
    "correct values, compression silently lost (the convert-commuting "
    "bug class documented at comm/allreduce.py _exchange: the bf16 "
    "all-gather observed lowering as f32)",
    "bracket the collective's payload with lax.optimization_barrier "
    "immediately before AND after the wire op (see comm/allreduce.py "
    "_exchange for the canonical shape)")

register_rule(
    "MX309", "warning",
    "implicit host sync inside a step loop: `.item()`/`.cpu()`/"
    "`.numpy()`/`.asnumpy()`/`np.asarray(...)`/`float(x)` on device "
    "values in the same loop that dispatches the train/eval/predict step "
    "— each one blocks the host until the card drains, serializing the "
    "asynchronous launch queue (and the comm/compute overlap schedule) "
    "and skewing memory accounting with transient host copies",
    "hoist the read out of the loop (pull once per epoch, like the device "
    "metric path), keep values on device, or — when the sync is the "
    "point (guard verdicts, host metrics) — annotate the line with "
    "`# mxlint: disable=MX309` and a justification")

register_rule(
    "MX310", "warning",
    "world-size/axis-size literal captured in a closure: a nested "
    "function closes over a variable bound to an integer literal whose "
    "name says world/axis size (world_size, num_workers, axis_size, "
    "ndev, num_devices, n_workers, n_devices, nproc) — under elastic "
    "training the world resizes mid-run, and a size frozen "
    "into a closure at build time silently keeps describing the dead "
    "world after a resize",
    "derive the size where it is used (int(mesh.shape['dp']), "
    "kv.num_workers, coordinator.world_size) or pass it as an argument "
    "from the mesh/coordinator provider so every (re)build of the "
    "closure sees the current world")

register_rule(
    "MX311", "warning",
    "direct fleet actuation outside the policy loop: a call to "
    "ElasticCoordinator.kill/request_world or "
    "set_gradient_compression outside resilience/controller.py (and "
    "tests/examples) — actuation that bypasses the FleetController "
    "skips its safety rails (K-of-N hysteresis, per-lever cooldowns, "
    "dry-run, rate limits, the controller circuit breaker) and leaves "
    "no `controller` decision event for telemetry diff / flight "
    "post-mortems to gate on",
    "route the change through FleetController (fit(controller=...), or "
    "coordinator-level policies it already owns); a deliberate "
    "out-of-loop site (launcher setup, recovery tooling) carries "
    "`# mxlint: disable=MX311` with a justification")

register_rule(
    "MX312", "warning",
    "CUDA kernel outside the kernel layer, or unpriced: a "
    "torch.utils.cpp_extension.load/load_inline or a @triton.jit kernel "
    "outside mxnet_tpu_torch/kernels/, or a kernel launch counted there, "
    "bypasses the kernel layer's route by device, its launch counts and "
    "the kernel registry; a module inside kernels/ that launches a kernel "
    "without registering a FLOP/byte model leaves that kernel out of the "
    "MFU count and the bounds every kernel is measured against",
    "move the kernel into mxnet_tpu_torch/kernels/ (its source in csrc/, "
    "built by _common.load_library) and call "
    "registry.register_kernel(name, cost_fn, ...) for it; a deliberate "
    "out-of-layer kernel (prototype, vendored code) carries "
    "`# mxlint: disable=MX312` with a justification")

register_rule(
    "MX313", "warning",
    "per-leaf Python loop over gradients inside a captured function that "
    "materializes per-leaf host statistics: each "
    "`float(...)`/`.item()`/`.cpu()`/numpy call inside the loop is a sync "
    "per parameter per step (and raises under capture) — the pattern the "
    "in-graph health stats engine (telemetry.health) replaces with ONE "
    "fused per-layer reduction pass and a single tiny pull",
    "compute the statistics inside the step program — fit(health=True) "
    "gives per-layer grad/weight/update norms + nonfinite counts on "
    "device (telemetry.health.device_stats for custom stats) — and pull "
    "one stacked vector after the step retires; a deliberate host-side "
    "per-leaf loop (debug tooling) carries `# mxlint: disable=MX313` "
    "with a justification")

register_rule(
    "MX314", "warning",
    "raw torch profiler capture outside the profiling layer, or a "
    "start_trace/start_capture without a finally-guarded stop: the "
    "profiler holds one trace per process, so a stray "
    "`torch.profiler.profile` / `torch.autograd.profiler.profile` / "
    "`torch.cuda.profiler.start` outside utils/profiler.py / "
    "telemetry/profiling.py races the framework's bounded capture "
    "windows, is invisible to the JSONL stream (no hub event), and is "
    "never priced as `profile` badput; a start whose stop is not in a "
    "`finally` leaks a running trace past the first exception — every "
    "later capture then fails",
    "route captures through telemetry.profiling (capture() / "
    "start_capture + finally-guarded stop_capture) or "
    "utils.profiler.profile_step; a deliberate raw capture carries "
    "`# mxlint: disable=MX314` with a justification")

register_rule(
    "MX315", "warning",
    "direct sharded-checkpoint write (`save_sharded` / `_save_sharded` / "
    "`_write_manifest`) outside utils/checkpoint.py / "
    "resilience/ckpt_async.py: the async checkpoint plane owns durability "
    "ordering — tmp-dir staging, CRC manifest commit, retention GC and "
    "the writer-thread flush barriers that keep synchronous saves from "
    "racing an in-flight async write of the same step; a stray direct "
    "write bypasses the `checkpoint` badput pricing and telemetry "
    "gauges, can interleave with the writer on the same `.tmp.<step>` "
    "dir, and is invisible to keep-last-k retention",
    "route saves through resilience.ckpt_async (AsyncCheckpointWriter"
    ".submit for the async tier, ckpt_async.save_now for synchronous "
    "barriers) or fit(sharded_checkpoint_dir=..., "
    "checkpoint_every_n_steps=...); a deliberate direct write carries "
    "`# mxlint: disable=MX315` with a justification")

register_rule(
    "MX316", "warning",
    "hand-rolled run-summary emission or direct ledger-dir consultation "
    "(`emit(\"run_summary\", ...)` / reading `MXNET_TPU_LEDGER_DIR`) "
    "outside telemetry/ledger.py: the cross-run ledger owns the RunRecord "
    "schema, the atomic one-file-per-record append discipline (tmp + "
    "rename + CRC sidecar) and the `run_summary` hub event that announces "
    "each append — a bypassing writer produces records the trend/compare "
    "gates cannot read, un-CRC'd files that read_ledger must treat as "
    "corrupt, and duplicate summary events that skew incident counts",
    "route run records through telemetry.ledger (record_run / "
    "append_record / publish_bench) and resolve the store directory via "
    "telemetry.ledger.ledger_dir(); a deliberate bypass carries "
    "`# mxlint: disable=MX316` with a justification")

register_rule(
    "MX306", "warning",
    "un-barriered wall-clock delta around device work: a "
    "time.time()/perf_counter() start/stop pair with work between and no "
    "torch.cuda.synchronize / Event.synchronize / host read of a tensor "
    "(.item()/.cpu()/.numpy()) — kernels launch asynchronously, so this "
    "measures the enqueue, not the execution (the timing footgun the "
    "telemetry layer exists to prevent)",
    "synchronize before reading the clock (torch.cuda.synchronize(), an "
    "event's synchronize(), or utils.profiler.Timer with t.block(out)), "
    "time the card with CUDA events (Event.elapsed_time), or route the "
    "measurement through mxnet_tpu_torch.telemetry (timed() / "
    "StepTimeline)")

# MX4xx — graph verifier (Symbol.verify)
register_rule(
    "MX401", "error",
    "duplicate argument name in graph",
    "give each Variable / auto-created parameter a unique name; binding "
    "maps arrays by name, so duplicates silently alias storage")
register_rule(
    "MX402", "error",
    "shape conflict in graph",
    "fix the op's input shapes; the error names the op and its input chain")
register_rule(
    "MX403", "error",
    "dtype conflict in graph",
    "insert an explicit cast or fix the variable dtype; implicit mixed-"
    "dtype graphs promote silently on TPU and burn HBM")
register_rule(
    "MX404", "warning",
    "unused op output (computed, never consumed, not a graph head)",
    "drop the unused head or consume it; dead outputs still cost "
    "compute/HBM unless XLA proves them away")
register_rule(
    "MX405", "warning",
    "unreachable node in serialized graph (not on any path to a head)",
    "prune dead nodes when editing saved symbol JSON")
register_rule(
    "MX406", "warning",
    "shape/dtype underdetermined (inference incomplete before bind)",
    "declare Variable(shape=...)/Variable(dtype=...) or pass known shapes "
    "to verify()")

# MX5xx — program audit
register_rule(
    "MX501", "warning",
    "host callback / device-to-host transfer inside compiled program",
    "remove callbacks from the hot path; each one stalls the TPU pipeline "
    "on a host round-trip")
register_rule(
    "MX502", "warning",
    "unexpected dtype promotion in compiled program",
    "check preferred_element_type / explicit casts; a f32 leak in a bf16 "
    "program doubles that tensor's HBM traffic")

# MX6xx — robustness (source pass)
register_rule(
    "MX601", "error",
    "bare `except:` swallows KeyboardInterrupt/SystemExit and masks the "
    "real failure",
    "catch a concrete exception type (at minimum `except Exception:`)")
# MX7xx — concurrency (analysis/concurrency.py)
register_rule(
    "MX701", "warning",
    "shared mutable state written from two or more thread entry points "
    "with no common lock: at least two of {thread targets, GC/weakref "
    "callbacks, signal handlers, hub sinks, server handlers, the main "
    "thread} mutate the same attribute/global and no single lock covers "
    "every mutation site — a lost-update/torn-state race",
    "guard every mutation of the shared attribute with ONE lock (the "
    "analysis.lockwatch factory gives it a name the runtime watchdog can "
    "see), or make the state thread-local/queue-passed; if the sharing "
    "is provably safe (e.g. GIL-atomic flag, single-writer), pragma the "
    "line with a one-line justification")
register_rule(
    "MX702", "warning",
    "inconsistent lock-acquisition order across functions: the static "
    "lock graph (who acquires what while holding what, merged over the "
    "whole linted file set) contains a cycle — two threads interleaving "
    "the two orders deadlock, and no test that doesn't hit the exact "
    "interleaving will ever catch it",
    "pick one global order for the locks in the cycle and acquire in "
    "that order everywhere (release-then-reacquire if needed); verify "
    "at runtime with MXNET_TPU_LOCKWATCH=1 (analysis.lockwatch reports "
    "cycles as flight-recorder incidents)")
register_rule(
    "MX703", "warning",
    "`cv.wait()` without a predicate loop: condition waits wake "
    "spuriously and on ANY notify, so a bare wait() proceeds on state "
    "that isn't there yet",
    "use `cv.wait_for(predicate, timeout=...)` (the repo idiom — see "
    "kvstore._GroupServer), or re-check the predicate in a while loop "
    "around the wait")
register_rule(
    "MX704", "warning",
    "non-daemon thread never joined: it outlives every shutdown path, "
    "keeps the interpreter alive at exit, and its work races teardown "
    "(module globals become None during finalization)",
    "pass daemon=True for fire-and-forget service threads, or keep the "
    "handle and join() it on every shutdown path (close/stop/__exit__)")
register_rule(
    "MX705", "warning",
    "locking a freshly-constructed lock: `with threading.Lock():` (or "
    "the `with getattr(self, '_lock', threading.Lock()):` fallback "
    "pattern) creates a new private lock per call — every caller locks "
    "its own instance and the critical section guards nothing",
    "construct the lock once (in __init__, via analysis.lockwatch."
    "named_lock) and reuse that single instance at every site")

# MX8xx — sharding / collective audit (analysis/sharding.py; MX805 rides
# with the source pass)
register_rule(
    "MX801", "warning",
    "large intermediate fully replicated while the mesh has dp>1: a "
    "sharding constraint (or lowered program input) pins a tensor above "
    "the size threshold to full replication, so every device holds and "
    "computes the whole thing — a silent HBM-times-n and compute-times-n "
    "multiplier the partitioner will happily lower without complaint",
    "shard the tensor over the mesh (PartitionSpec naming a mesh axis, "
    "e.g. P('dp') on the batch dim) or drop the constraint and let "
    "sharding propagate from the inputs; genuinely-replicated large "
    "state (frozen embeddings) deserves a comment at the constraint "
    "site and a raised min_replicated_bytes in the audit call")
register_rule(
    "MX802", "error",
    "collective-set drift: the compiled HLO's collective table does not "
    "reconcile against the closed-form allreduce_plan/overlap_plan — an "
    "unplanned all-gather/all-to-all/collective-permute crossed the "
    "wire, a planned collective is missing (compression silently "
    "dropped), or a payload's element count/dtype disagrees with the "
    "plan (the convert-commuting bug class: the wire op lowered at the "
    "wrong width)",
    "inspect the reconciliation rows (analysis.sharding."
    "audit_collective_drift): every HLO collective must be one the plan "
    "priced; re-pin payloads with lax.optimization_barrier (MX308) if a "
    "cast commuted across the wire op, and update the plan if the "
    "program's comm schedule legitimately changed")
register_rule(
    "MX803", "warning",
    "collective inside a scan/while body: the wire cost is paid per "
    "iteration, multiplying a one-shot collective's bytes by the trip "
    "count — invisible to the per-step comm plan, which prices the "
    "program's collectives exactly once",
    "hoist the collective out of the loop (reduce locally, sync once "
    "after), or — when per-iteration comm IS the algorithm (ring "
    "attention's rotating collective-permute) — account it explicitly "
    "and suppress the finding at the audit call site")
register_rule(
    "MX804", "error",
    "degenerate PartitionSpec: the spec names an axis the mesh does not "
    "have (XLA treats the dim as replicated — the sharding silently "
    "never happens), or the batch dimension is unsharded while the mesh "
    "has dp>1 (every device computes the full batch)",
    "use mesh axis names exactly as make_mesh declared them (dp/tp/sp) "
    "and shard the batch dim with P('dp') whenever the dp axis is >1")
register_rule(
    "MX805", "warning",
    "raw sharding placement outside parallel/ + comm/: a "
    "torch.distributed.tensor placement (distribute_tensor, "
    "DTensor.from_local) or a `Sharding(...).shard(...)` call site "
    "outside the owner layers scatters placement decisions across the "
    "codebase — the audit pass and the comm plan can only vouch for wire "
    "traffic whose placement flows through the owners "
    "(parallel.shard_batch / replicate_params, a model's param_shardings)",
    "route the placement through mxnet_tpu_torch.parallel (shard_batch, "
    "replicate_params, the Sharding a model's param_shardings gives) or "
    "the model entry points; a deliberate placement site (checkpoint "
    "restore, a model's declared weight shardings) carries "
    "`# mxlint: disable=MX805` with a justification")

register_rule(
    "MX602", "error",
    "unbounded retry loop: `while True` swallowing exceptions with no "
    "backoff, deadline, or attempt bound",
    "use resilience.retry.retry_call / RetryPolicy (bounded retries, "
    "exponential backoff + jitter), or add a sleep/deadline to the loop")
