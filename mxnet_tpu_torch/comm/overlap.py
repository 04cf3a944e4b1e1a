"""The overlapped gradient exchange: per-bucket quantized sync, each bucket
started as soon as backward has filled it.

Counterpart of ``mxnet_tpu/comm/overlap.py``. The gradient set is split
into ``GradBucketer`` slabs in reverse-topological parameter order (last
layers first, the order backward produces their gradients), and each
bucket runs the quantized exchange of ``comm/allreduce.py`` as its own
collectives, with its own error-feedback residual. Plans, bucket names,
sizes, padding and layout keys are the JAX package's exactly.

Where the JAX package leaves the interleaving to XLA's scheduler inside one
program, here :class:`OverlapSchedule` does it by hand: a post-accumulate
hook counts each bucket's parameters, and the bucket whose last gradient
has landed is handed to one comm thread, which issues the buckets strictly
in plan order (gloo needs every rank to issue its collectives in the same
order, and autograd's hooks on a card run on its device thread) on a side
stream that waits on the bucket's event. Buckets that backward never made
ready (a parameter without a gradient) start after ``backward()`` returns,
in plan order. The update waits on each bucket's event.

Entry points: ``FeedForward.fit(compression=..., overlap=...)``,
``parallel.make_data_parallel_step(compression=..., overlap=...)``, and
the stale-sync mode of ``dist_async`` (``AsyncKVStore.push_pull_stale``).
Wire accounting: ``comm.stats.overlap_plan``.
"""

from __future__ import annotations

import hashlib
import os
import threading

import torch

from ..base import MXNetError
from .allreduce import (CommKernelConfig, compressed_allreduce,
                        compressed_exchange, error_feedback_allreduce,
                        error_feedback_exchange, flat_views,
                        init_error_feedback, padded_flat_size)
from .bucketing import DEFAULT_BUCKET_BYTES, GradBucketer
from .compression import CompressionSpec

__all__ = ["OverlapConfig", "OverlapPlan", "plan_overlap",
           "reverse_topo_param_order", "overlap_allreduce",
           "init_overlap_residuals", "residuals_match_plan",
           "fused_layout_key", "overlap_efficiency", "OverlapSchedule"]

_OFF_VALUES = ("", "0", "off", "false", "no", "none")
_ON_VALUES = ("1", "on", "true", "yes")


class OverlapConfig:
    """What the ``overlap=`` knob resolved to: ``bucket_bytes``, the f32
    byte cap of a gradient slab (4 MB by default)."""

    def __init__(self, bucket_bytes=DEFAULT_BUCKET_BYTES):
        self.bucket_bytes = int(bucket_bytes)
        if self.bucket_bytes <= 0:
            raise MXNetError("overlap bucket_bytes must be positive")

    def __repr__(self):
        return f"OverlapConfig(bucket_bytes={self.bucket_bytes})"

    def key(self):
        return ("overlap", self.bucket_bytes)

    @classmethod
    def resolve(cls, value):
        """None -> the ``MXNET_TPU_COMM_OVERLAP`` variable (unset or falsy:
        off, truthy: 4 MB buckets, an integer: the cap); True -> default;
        an int -> that cap; a config passes through."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_COMM_OVERLAP", "").strip().lower()
            if raw in _OFF_VALUES:
                return None
            if raw in _ON_VALUES:
                return cls()
            value = raw
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        try:
            return cls(int(value))
        except (TypeError, ValueError):
            raise MXNetError(
                f"overlap= must be True/False, a bucket byte cap, or an "
                f"OverlapConfig; got {value!r}") from None


def reverse_topo_param_order(symbol, param_names):
    """``param_names`` in the order backward completes their gradients:
    by the topological index of each one's first consumer, descending
    (last layers first). Ties keep the caller's order; names the graph
    never consumes go last."""
    wanted = set(param_names)
    first_use = {}
    for idx, node in enumerate(symbol._topo()):
        if node.is_variable:
            continue
        for src, _ in node.inputs:
            if src.is_variable and src.name in wanted:
                cur = first_use.get(src.name)
                if cur is None or idx < cur:
                    first_use[src.name] = idx
    ranked = sorted((n for n in param_names if n in first_use),
                    key=lambda n: -first_use[n])
    return ranked + [n for n in param_names if n not in first_use]


class OverlapPlan:
    """The static per-bucket schedule: which parameters fuse into which
    slab, in schedule order, and each bucket's padded length. The sync,
    the residual ledgers, the wire plan and the layout key all derive from
    it."""

    def __init__(self, spec, axis_size, buckets):
        self.spec = spec
        self.axis_size = int(axis_size)
        # [{"name", "keys", "shapes", "size", "padded"}] in schedule order
        self.buckets = buckets

    @property
    def num_buckets(self):
        return len(self.buckets)

    def bucket_elems(self):
        """``[(bucket_name, num_elements), ...]`` in schedule order."""
        return [(b["name"], b["size"]) for b in self.buckets]

    def padded_sizes(self):
        """``{bucket_name: padded_length}`` (residual row lengths)."""
        return {b["name"]: b["padded"] for b in self.buckets}

    def param_keys(self):
        return [k for b in self.buckets for k in b["keys"]]

    def layout_key(self) -> str:
        """Identity of (schedule, shapes, spec, axis size): whether saved
        per-bucket residuals still describe these buckets."""
        desc = (self.spec.key(), self.axis_size,
                [(b["name"], b["keys"], b["shapes"]) for b in self.buckets])
        return "overlap:" + hashlib.sha1(repr(desc).encode()).hexdigest()[:16]

    def wire_plan(self) -> dict:
        """The exact per-bucket comm plan (:func:`stats.overlap_plan`)."""
        from .stats import overlap_plan

        return overlap_plan(self.bucket_elems(), self.axis_size, self.spec)

    def replan(self, axis_size) -> "OverlapPlan":
        """The same buckets on another axis size: only the padded lengths
        and the layout key change."""
        axis_size = int(axis_size)
        buckets = [{**b, "padded": padded_flat_size(b["size"], self.spec,
                                                    axis_size)}
                   for b in self.buckets]
        return OverlapPlan(self.spec, axis_size, buckets)

    def __repr__(self):
        return (f"OverlapPlan(mode={self.spec.mode!r}, "
                f"axis_size={self.axis_size}, buckets={self.num_buckets})")


def plan_overlap(shapes, compression, axis_size,
                 max_bytes=DEFAULT_BUCKET_BYTES, symbol=None):
    """The per-bucket schedule of a parameter set (``{name: shape}`` or
    ``[(name, shape), ...]``). With ``symbol`` the order comes from the
    graph (:func:`reverse_topo_param_order`); without one, names sorted
    and reversed."""
    spec = CompressionSpec.resolve(compression)
    if spec is None:
        raise MXNetError("plan_overlap needs an active compression mode "
                         "(the overlapped schedule pipelines the quantized "
                         "per-bucket sync)")
    axis_size = int(axis_size)
    items = list(shapes.items()) if isinstance(shapes, dict) \
        else [(k, tuple(s)) for k, s in shapes]
    by_name = {k: tuple(int(d) for d in s) for k, s in items}
    if symbol is not None:
        ordered = reverse_topo_param_order(symbol, [k for k, _ in items])
    else:
        ordered = sorted(by_name)[::-1]
    bucketer = GradBucketer([(n, by_name[n]) for n in ordered],
                            max_bytes=max_bytes)
    buckets = [{"name": b["name"], "keys": list(b["keys"]),
                "shapes": list(b["shapes"]), "size": b["size"],
                "padded": padded_flat_size(b["size"], spec, axis_size)}
               for b in bucketer.buckets]
    return OverlapPlan(spec, axis_size, buckets)


def _check_keys(tree, plan):
    keys = plan.param_keys()
    missing = [k for k in keys if k not in tree]
    extra = [k for k in tree if k not in set(keys)]
    if missing or extra:
        raise MXNetError(
            f"overlap_allreduce: gradient keys do not match the plan "
            f"(missing={missing[:3]}, unplanned={extra[:3]}); rebuild the "
            f"plan with plan_overlap for this parameter set")


def overlap_allreduce(tree, residuals, plan, group=None, average=False,
                      kernels=None):
    """Sync a gradient dict bucket by bucket, in ``plan``'s order, each
    bucket its own quantized exchange over the ranks of ``group``.

    ``residuals``: ``{bucket_name: (1, Lp_b)}``, this rank's rows of the
    JAX package's ``(axis_size, Lp_b)`` ledgers
    (:func:`init_overlap_residuals`), or None for modes without feedback.
    Returns ``(synced_tree, new_residuals)``. ``kernels`` (anything
    ``CommKernelConfig.resolve`` takes) routes the quantize stages through
    the fused kernels."""
    _check_keys(tree, plan)
    use_ef = plan.spec.error_feedback and residuals is not None
    out = {}
    new_res = dict(residuals) if use_ef else residuals
    for b in plan.buckets:
        sub = {k: tree[k] for k in b["keys"]}
        if use_ef:
            synced, r = error_feedback_allreduce(
                sub, residuals[b["name"]], plan.spec, group=group,
                axis_size=plan.axis_size, average=average, kernels=kernels)
            new_res[b["name"]] = r
        else:
            synced = compressed_allreduce(
                sub, plan.spec, group=group, axis_size=plan.axis_size,
                average=average, kernels=kernels)
        out.update(synced)
    return out, new_res


def init_overlap_residuals(plan, dtype=None, device=None):
    """Zero per-bucket error-feedback state for ``plan``: this rank's
    ``{bucket_name: (1, Lp_b)}`` rows, or None when the mode needs none."""
    if not plan.spec.error_feedback:
        return None
    return {b["name"]: init_error_feedback(b["size"], plan.spec,
                                           plan.axis_size, dtype, device)
            for b in plan.buckets}


def residuals_match_plan(residuals, plan) -> bool:
    """Do saved residual rows still describe ``plan``'s buckets (names and
    ``(1, Lp_b)`` shapes)?"""
    if not plan.spec.error_feedback:
        return residuals is None
    if not isinstance(residuals, dict):
        return False
    expected = {b["name"]: (1, b["padded"]) for b in plan.buckets}
    if set(residuals) != set(expected):
        return False
    return all(tuple(int(d) for d in residuals[n].shape) == shape
               for n, shape in expected.items())


def overlap_efficiency(step_seconds, compute_seconds, comm_seconds) -> float:
    """How much of the smaller of compute and comm the schedule hid:
    ``1 - (step - max(compute, comm)) / min(compute, comm)``, capped at 1
    (1: perfect pipelining, 0: serial, negative: worse than serial); 0.0
    when either side is about zero."""
    lo = min(float(compute_seconds), float(comm_seconds))
    if lo <= 0.0:
        return 0.0
    return min(1.0, 1.0 - (float(step_seconds)
                           - max(float(compute_seconds),
                                 float(comm_seconds))) / lo)


def fused_layout_key(num_elements, spec, axis_size) -> str:
    """Layout identity of the single fused-bucket residual."""
    lp = padded_flat_size(num_elements, spec, int(axis_size))
    return (f"fused:{spec.mode}:{spec.threshold}:{spec.chunk}:"
            f"{int(axis_size)}:{int(num_elements)}:{lp}")


class OverlapSchedule:
    """The overlapped exchange of one rank's gradients over a plan, or of
    every replica's over a :class:`~.allreduce.ReplicaGroup`.

    One padded f32 buffer a member holds the gradients bucket by bucket in
    plan order, each bucket ``padded`` long, its parameters in sorted-name
    order (the layout the bucket's exchange flattens to), so every
    parameter's ``.grad`` is a view into its bucket and autograd
    accumulates in place. With error feedback a bucket's slice is its
    residual row: backward adds into it, and its exchange writes the new
    residual back; else the buffer is zeroed before each backward. A
    bucket is ready when every member's parameters of it have landed.

    Per step: :meth:`attach` (before backward), :meth:`finish_backward`
    (after it), :meth:`wait` (the synced gradients, with the current
    stream waiting on each bucket). A backward that gets no gradient for
    some parameter still starts its bucket, in :meth:`finish_backward`.

    On a card the comm thread runs each exchange on a side stream that
    waits on the event recorded where the bucket's last gradient landed;
    the gloo stages copy through pinned host buffers as
    ``comm/allreduce.py`` does: gloo reads a buffer only after its copy
    from the card returned, and torch's caching host allocator reuses a
    pinned buffer only after the copy of the result back to the card has
    run. Replicas on several cards exchange a bucket once every card has
    finished the work queued before it (a device-wide synchronization),
    and the update runs after the exchange's copies have finished."""

    def __init__(self, plan, device, group=None, kernels=None):
        from .allreduce import ReplicaGroup

        self.plan = plan
        self.spec = plan.spec
        self.group = group
        self.kernels = CommKernelConfig.resolve(kernels)
        devices = group.devices if isinstance(group, ReplicaGroup) \
            else [device]
        self.replicas = isinstance(group, ReplicaGroup)
        self.devices = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            self.devices.append(d)
        self.device = self.devices[0]
        self.feedback = plan.spec.error_feedback
        self.offsets, off = [], 0
        self.bucket_of, self.shapes = {}, []
        for i, b in enumerate(plan.buckets):
            self.offsets.append(off)
            off += b["padded"]
            self.shapes.append(dict(zip(b["keys"], b["shapes"])))
            for k in b["keys"]:
                self.bucket_of[k] = i
        self.flats = [torch.zeros(off, dtype=torch.float32, device=d)
                      for d in self.devices]
        members = len(self.devices)
        self._counts = [len(b["keys"]) * members for b in plan.buckets]
        cuda = {d for d in self.devices if d.type == "cuda"}
        # replicas on several cards: exchange after a device-wide sync
        self._sync_all = len(cuda) > 1
        self._stream = torch.cuda.Stream(self.device) \
            if cuda and not self._sync_all else None
        self._cv = threading.Condition()
        self._left = None       # per bucket: parameters still to land
        self._ready = None      # per bucket: None, or (event or True)
        self._results = None    # per bucket: (outs, done event)
        self._error = None
        self._done = True
        self._hooks = []
        self._hooked = None
        self._jobs = []
        self._thread = threading.Thread(target=self._comm_loop, daemon=True,
                                        name="mxtorch-overlap-comm")
        self._closed = False
        self._thread.start()

    @property
    def flat(self) -> torch.Tensor:
        """The first member's buffer (a rank's only one)."""
        return self.flats[0]

    # -- layout ----------------------------------------------------------------
    def bucket_slice(self, i, member=0) -> torch.Tensor:
        off = self.offsets[i]
        return self.flats[member][off:off + self.plan.buckets[i]["padded"]]

    def views(self, member=0) -> dict:
        """Each parameter's view of a member's buffer (its ``.grad``)."""
        out = {}
        for i in range(self.plan.num_buckets):
            out.update(flat_views(self.bucket_slice(i, member),
                                  self.shapes[i]))
        return out

    def residuals(self) -> dict:
        """``{bucket_name: (members, Lp_b)}``: the residual rows between
        steps, views of the buffer for one member, a stacked copy (on the
        first member's device) for several; None without feedback."""
        if not self.feedback:
            return None
        if len(self.flats) == 1:
            return {b["name"]: self.bucket_slice(i)[None]
                    for i, b in enumerate(self.plan.buckets)}
        return {b["name"]: torch.stack([
            self.bucket_slice(i, m).to(self.device)
            for m in range(len(self.flats))])
            for i, b in enumerate(self.plan.buckets)}

    def load_residuals(self, rows: dict):
        """Copy saved ``{bucket_name: (members, Lp_b)}`` rows into the
        buffers (a resumed fit's ledgers)."""
        for i, b in enumerate(self.plan.buckets):
            saved = rows[b["name"]]
            for m in range(len(self.flats)):
                self.bucket_slice(i, m).copy_(
                    torch.as_tensor(saved[m]).to(self.devices[m]))

    # -- the step --------------------------------------------------------------
    def attach(self, params):
        """Before backward: point every ``.grad`` at its view, zero the
        buffers without feedback, and arm the counts. ``params`` is one
        dict, or one a member for a replica group."""
        members = list(params) if self.replicas else [params]
        for p in members:
            _check_keys(p, self.plan)
        if not self._done:
            raise MXNetError("OverlapSchedule.attach: the last step's "
                             "exchange was not waited for")
        if not self.feedback:
            for flat in self.flats:
                flat.zero_()
        for m, p in enumerate(members):
            views = self.views(m)
            for k, t in p.items():
                t.grad = views[k]
        pairs = [(k, t) for p in members for k, t in p.items()]
        if self._hooked is None or len(self._hooked) != len(pairs) or any(
                h is not t for h, (_, t) in zip(self._hooked, pairs)):
            for h in self._hooks:
                h.remove()
            self._hooks = [t.register_post_accumulate_grad_hook(
                self._hook_for(k)) for k, t in pairs]
            self._hooked = [t for _, t in pairs]
        with self._cv:
            self._left = list(self._counts)
            self._ready = [None] * self.plan.num_buckets
            self._results = [None] * self.plan.num_buckets
            self._error = None
            self._done = False
            self._jobs.append(True)
            self._cv.notify_all()

    def _hook_for(self, name):
        i = self.bucket_of[name]

        def hook(_param):
            with self._cv:
                if self._ready is None or self._ready[i] is not None:
                    return
                self._left[i] -= 1
                if self._left[i] == 0:
                    self._ready[i] = self._marker()
                    self._cv.notify_all()
        return hook

    def _marker(self):
        """What a bucket's exchange waits on: an event on the stream where
        its last gradient landed (autograd's device thread), or True on
        the CPU and, after a device-wide sync, across several cards."""
        if self._sync_all:
            for d in set(self.devices):
                torch.cuda.synchronize(d)
            return True
        if self._stream is None:
            return True
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def finish_backward(self):
        """After backward: start every bucket not started yet, in plan
        order."""
        with self._cv:
            for i in range(self.plan.num_buckets):
                if self._ready[i] is None:
                    self._ready[i] = self._marker()
            self._cv.notify_all()

    def _comm_loop(self):
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._jobs or self._closed)
                if self._closed:
                    return
                self._jobs.pop(0)
            try:
                if self._stream is not None:
                    torch.cuda.set_device(self.device)
                for i in range(self.plan.num_buckets):
                    with self._cv:
                        self._cv.wait_for(lambda: self._ready[i] is not None
                                          or self._closed)
                        if self._closed:
                            return
                        marker = self._ready[i]
                    self._results[i] = self._exchange(i, marker)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def _exchange(self, i, marker):
        n = self.plan.axis_size
        flats = [self.bucket_slice(i, m) for m in range(len(self.flats))]
        if self._stream is None:
            outs = self._run_exchange(flats, n)
            if self._sync_all:
                for d in set(self.devices):
                    torch.cuda.synchronize(d)
            return outs, None
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(marker)
            outs = self._run_exchange(flats, n)
            done = torch.cuda.Event()
            done.record(self._stream)
        return outs, done

    def _run_exchange(self, flats, n):
        arg = flats if self.replicas else flats[0]
        if self.feedback:
            outs, resid = error_feedback_exchange(
                arg, self.spec, self.group, n, self.kernels)
            outs = outs if self.replicas else [outs]
            resid = resid if self.replicas else [resid]
            for flat, r in zip(flats, resid):
                flat.copy_(r[0])
            return outs
        outs = compressed_exchange(arg, self.spec, self.group, n,
                                   self.kernels)
        return outs if self.replicas else [outs]

    def wait(self):
        """The synced gradients (sum over the ranks) as views of each
        bucket's result; the current stream waits on every bucket. One
        dict, or one a member for a replica group."""
        with self._cv:
            self._cv.wait_for(lambda: self._done)
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        grads = [{} for _ in self.flats]
        current = torch.cuda.current_stream(self.device) \
            if self._stream is not None else None
        for i, (outs, done) in enumerate(self._results):
            for m, out in enumerate(outs):
                if done is not None:
                    current.wait_event(done)
                    out.record_stream(current)
                grads[m].update(flat_views(out, self.shapes[i]))
        self._results = None
        return grads if self.replicas else grads[0]

    def close(self):
        """Stop the comm thread and remove the hooks."""
        for h in self._hooks:
            h.remove()
        self._hooks, self._hooked = [], None
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
