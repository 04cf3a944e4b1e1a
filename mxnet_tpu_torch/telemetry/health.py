"""Training-health observability: per-layer statistics computed inside the
train step + streaming anomaly detection.

The port's counterpart of ``mxnet_tpu/telemetry/health.py``. Between
loss-in and params-out the *model* is otherwise a black box: a guard
would skip a NaN step without saying which layer blew up, and ``Monitor``
only reconstructs internals after the fact with an extra forward. Two
halves:

  **device** — :class:`DeviceStats` runs inside the training step (inside
  its CUDA graph on a card): per-layer gradient norm, weight norm,
  update:weight ratio and nonfinite element counts (parameters grouped
  into layers by :func:`layer_groups`), plus the unscaled loss, written
  into static buffers of the program (:func:`init_device_stats`'s four
  ``(L,)`` vectors and a scalar), so a replay refreshes them and the host
  reads the small vectors after the step retires. The port's optimizer
  updates the weights in place, so the step keeps a copy of the
  pre-update weights (``weight_norm`` and the update's ``‖w_new −
  w_old‖`` read it), where the JAX step reads its ``params`` and
  ``new_params``. :func:`device_stats` is the same computation as a pure
  function of ``params``, ``grads``, ``new_params`` and the loss.

  **host** — :class:`HealthMonitor` is a kind-filtered hub sink over the
  ``health`` events the fit loop emits once per step
  (:func:`observe_device_stats`). Streaming detectors, O(window) state:

    loss spike        | MAD z-score of the loss against a rolling window
    grad explosion    | per-layer EWMA/MAD z-score + an absolute limit
    dead layer        | update:weight ratio ~0 for K consecutive steps
    divergence drift  | fast loss EWMA above slow EWMA, sustained
    nonfinite         | any NaN/Inf element in a layer's gradients

  Each hit is a ``health_anomaly`` event — an *incident* kind, so it lands
  in the flight recorder's incident ring — plus per-layer ``health_*``
  gauges.

CLI: ``python -m mxnet_tpu_torch.telemetry health run.jsonl`` renders the
per-layer table + anomaly timeline.
"""

from __future__ import annotations

import collections
import math
import os

from ..analysis.lockwatch import named_lock
from ..base import ENV_OFF_VALUES

__all__ = ["HealthConfig", "HealthMonitor", "layer_groups", "layer_of",
           "init_device_stats", "device_stats", "DeviceStats",
           "stats_to_host", "observe_device_stats", "loss_heads",
           "loss_value", "aggregate_events", "ANOMALY_REASONS"]

ANOMALY_REASONS = ("nonfinite", "grad_explosion", "loss_spike",
                   "dead_layer", "divergence_drift")

# parameter-name suffixes folded into their owning layer (fc1_weight +
# fc1_bias -> layer "fc1"; BatchNorm's gamma/beta likewise)
_PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta")


def layer_of(param_name: str) -> str:
    """Layer a parameter belongs to (strip the trailing role suffix)."""
    for suffix in _PARAM_SUFFIXES:
        if param_name.endswith("_" + suffix):
            return param_name[: -(len(suffix) + 1)]
    return param_name


def layer_groups(param_names):
    """Ordered ``{layer: (param names...)}`` — the fixed layer order both
    the in-step stats engine and the host consumers index by."""
    groups: dict = {}
    for name in sorted(param_names):
        groups.setdefault(layer_of(name), []).append(name)
    return {layer: tuple(names) for layer, names in sorted(groups.items())}


class HealthConfig:
    """What ``fit(health=...)`` turns on, and the detector thresholds.

    ``every``: observe/emit stats every N steps (1 = every step).
    ``window``: rolling loss window for the MAD z-score; ``loss_z`` its
    threshold. ``grad_z``: per-layer grad-norm EWMA z-score threshold;
    ``grad_limit``: absolute grad-norm ceiling (fires with no warmup —
    catches a layer that is born exploding). ``dead_ratio``/``dead_steps``:
    update:weight ratio floor and how many consecutive sub-floor steps
    flag a dead layer. ``drift_tol``/``drift_steps``: sustained relative
    excess of the fast loss EWMA over the slow one that flags slow
    divergence. ``min_steps``: detector warmup (z-scores need a baseline).
    ``gauges``: export per-layer ``health_*`` gauges (on by default)."""

    def __init__(self, every=1, window=32, loss_z=6.0, grad_z=8.0,
                 grad_limit=1e6, dead_ratio=1e-12, dead_steps=20,
                 drift_tol=0.25, drift_steps=50, min_steps=8,
                 ewma_alpha=0.1, gauges=True):
        self.every = max(int(every), 1)
        self.window = max(int(window), 4)
        self.loss_z = float(loss_z)
        self.grad_z = float(grad_z)
        self.grad_limit = float(grad_limit)
        self.dead_ratio = float(dead_ratio)
        self.dead_steps = max(int(dead_steps), 1)
        self.drift_tol = float(drift_tol)
        self.drift_steps = max(int(drift_steps), 1)
        self.min_steps = max(int(min_steps), 2)
        self.ewma_alpha = float(ewma_alpha)
        self.gauges = bool(gauges)

    def __repr__(self):
        return (f"HealthConfig(every={self.every}, loss_z={self.loss_z}, "
                f"grad_z={self.grad_z}, grad_limit={self.grad_limit:g}, "
                f"dead_steps={self.dead_steps})")

    def key(self):
        """Hashable program-key component. The captured program only
        depends on health being ON — ``every`` and the thresholds are
        host-side, and keying on them would orphan captured programs."""
        return ("health",)

    @classmethod
    def resolve(cls, value):
        """Normalize fit()'s ``health`` argument: None -> env gate
        ``MXNET_TPU_HEALTH`` (unset/falsy = off), True -> defaults,
        HealthConfig -> itself."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_HEALTH", "").strip().lower()
            if not raw or raw in ENV_OFF_VALUES:
                return None
            value = True
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise ValueError(f"health must be bool/None/HealthConfig, "
                         f"got {type(value)}")


# -- device side (runs inside the training step) --------------------------------

def init_device_stats(groups, device="cpu"):
    """Zeroed health-state buffers for ``groups`` on ``device``: the step
    writes its statistics into them in place (fixed shapes, so a captured
    program keeps them)."""
    import torch

    n = len(groups)
    return {
        "grad_norm": torch.zeros(n, dtype=torch.float32, device=device),
        "weight_norm": torch.zeros(n, dtype=torch.float32, device=device),
        "update_ratio": torch.zeros(n, dtype=torch.float32, device=device),
        "nonfinite": torch.zeros(n, dtype=torch.int32, device=device),
        "loss": torch.zeros((), dtype=torch.float32, device=device),
    }


def _layer_index(groups, device):
    """The (layers, widest layer) gather index of :func:`_layer_sums`:
    each layer's leaves (in the groups' leaf order), padded with the
    index of a zero."""
    import torch

    names = [n for members in groups.values() for n in members]
    index = {name: i for i, name in enumerate(names)}
    width = max(len(v) for v in groups.values())
    pad = len(names)
    rows = [[index[n] for n in members] + [pad] * (width - len(members))
            for members in groups.values()]
    return torch.tensor(rows, dtype=torch.long, device=device)


def _layer_sums(idx, per_leaf):
    """Per-layer sums of a per-leaf vector by a fixed padded gather and a
    row sum (no atomics: the same bits on every run)."""
    import torch

    padded = torch.cat([per_leaf, per_leaf.new_zeros(1)])
    return padded[idx].sum(dim=1)


def _sq_norms(tensors):
    import torch

    if not tensors:
        return torch.zeros(0)
    return torch.stack([n.float() for n in torch._foreach_norm(
        [t.float() for t in tensors])]) ** 2


def _nonfinite(tensors):
    import torch

    return torch.stack([t.numel() - torch.isfinite(t).sum()
                        for t in tensors]).to(torch.int32)


def _nonfinite_flat(flat, starts, ends):
    """Per-leaf nonfinite counts of leaves that are slices
    ``flat[starts[i]:ends[i]]`` of one flat buffer: one pass over the
    buffer and a prefix sum, instead of a pass a leaf."""
    import torch

    bad = torch.logical_not(torch.isfinite(flat)).to(torch.int32)
    cs = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0,
                                                   dtype=torch.int32)])
    return cs[ends] - cs[starts]


def device_stats(groups, params, grads, new_params, loss, nonfinite=None,
                 index=None):
    """Per-layer statistics of one step from its ``params`` before the
    update, the ``grads`` the optimizer consumed and the ``new_params``
    after it (dicts of tensors by parameter name), and its unscaled
    ``loss``: ``{"grad_norm", "weight_norm", "update_ratio",
    "nonfinite", "loss"}`` as the JAX package computes them.
    ``nonfinite``: the per-leaf nonfinite counts when the caller has them
    (:func:`_nonfinite_flat`), leaves in the groups' order; ``index``:
    :func:`_layer_index` made ahead (a captured step makes no tensor from
    host values)."""
    import torch

    names = [n for members in groups.values() for n in members]
    with torch.no_grad():
        if index is None:
            index = _layer_index(groups, grads[names[0]].device)
        g = [grads[n] for n in names]
        w = [params[n].detach().float() for n in names]
        d = torch._foreach_sub([new_params[n].detach().float()
                                for n in names], w)
        if nonfinite is None:
            nonfinite = _nonfinite(g)
        weight_norm = torch.sqrt(_layer_sums(index, _sq_norms(w)))
        return {
            "grad_norm": torch.sqrt(_layer_sums(index, _sq_norms(g))),
            "weight_norm": weight_norm,
            "update_ratio": torch.sqrt(_layer_sums(index, _sq_norms(d)))
            / (weight_norm + 1e-12),
            "nonfinite": _layer_sums(index, nonfinite.to(torch.int64))
            .to(torch.int32),
            "loss": torch.as_tensor(loss).float().reshape(()),
        }


class DeviceStats:
    """The statistics of a training step held in static buffers
    (``buffers``, :func:`init_device_stats`'s layout) over the step's
    parameter tensors, which the optimizer updates in place.
    :meth:`before_update` keeps the pre-update weights (one copy, into a
    buffer made once) and :meth:`after_update` writes the five statistics
    into the buffers. Everything runs on the step's stream, so a captured
    step records it and every replay refreshes the buffers."""

    def __init__(self, groups, params: dict, device, flat_grad=None,
                 grad_views=None):
        import torch

        self.groups = groups
        self._index = _layer_index(groups, device)
        # gradients that are views of one flat buffer: their nonfinite
        # counts take one pass over it
        self._flat = None
        if flat_grad is not None and grad_views is not None:
            base = flat_grad.data_ptr()
            item = flat_grad.element_size()
            starts = [(grad_views[n].data_ptr() - base) // item
                      for members in groups.values() for n in members]
            ends = [a + grad_views[n].numel() for a, n in zip(
                starts, [n for m in groups.values() for n in m])]
            self._flat = (flat_grad, grad_views,
                          torch.tensor(starts, dtype=torch.long,
                                       device=device),
                          torch.tensor(ends, dtype=torch.long,
                                       device=device))
        self.names = [n for members in groups.values() for n in members]
        self.buffers = init_device_stats(groups, device)
        sizes = [params[n].numel() for n in self.names]
        self._old_flat = torch.empty(sum(sizes), dtype=torch.float32,
                                     device=device)
        self._old = {n: self._old_flat[o:o + k].view(params[n].shape)
                     for n, o, k in zip(self.names,
                                        [sum(sizes[:i]) for i in
                                         range(len(sizes))], sizes)}

    def before_update(self, params: dict):
        import torch

        with torch.no_grad():
            torch._foreach_copy_([self._old[n] for n in self.names],
                                 [params[n].detach().float()
                                  for n in self.names])

    def after_update(self, params: dict, grads: dict, loss):
        import torch

        with torch.no_grad():
            counts = None
            if self._flat is not None and grads is self._flat[1]:
                counts = _nonfinite_flat(self._flat[0], *self._flat[2:])
            stats = device_stats(self.groups, self._old, grads, params, loss,
                                 nonfinite=counts, index=self._index)
            for k, v in stats.items():
                self.buffers[k].copy_(v)


def loss_heads(symbol, input_names):
    """``(head index, op, label input)`` of each loss head whose label is
    an input: the heads whose ``loss_value`` makes the health loss."""
    del input_names
    return tuple(
        (i, node.op, node.inputs[1][0].name)
        for i, (node, _k) in enumerate(symbol._heads)
        if not node.is_variable and getattr(node.op, "is_loss", False)
        and len(node.inputs) > 1 and node.inputs[1][0].is_variable)


def loss_value(heads, outs, batch, mask=None):
    """The true training loss of one step, summed over the loss heads
    (None when no head prices itself)."""
    total = None
    for i, op, label in heads:
        if label not in batch:
            continue
        value = op.loss_value(outs[i], batch[label], mask=mask)
        if value is None:
            continue
        total = value if total is None else total + value
    return total


# -- host side -----------------------------------------------------------------

def stats_to_host(groups, hstate):
    """One copy of the small stat vectors to the host -> plain python
    structure (JSON-ready). Call after the step retired."""
    import numpy as np

    host = {k: np.asarray(v.detach().cpu()) if hasattr(v, "detach")
            else np.asarray(v) for k, v in hstate.items()}
    layers = {}
    for i, layer in enumerate(groups):
        layers[layer] = {
            "grad_norm": float(host["grad_norm"][i]),
            "weight_norm": float(host["weight_norm"][i]),
            "update_ratio": float(host["update_ratio"][i]),
            "nonfinite": int(host["nonfinite"][i]),
        }
    loss = float(host["loss"])
    finite = bool(np.isfinite(loss)) and all(
        v["nonfinite"] == 0 and math.isfinite(v["grad_norm"])
        for v in layers.values())
    return layers, loss, finite


def observe_device_stats(groups, hstate, epoch, step):
    """Pull one step's device stats and emit the ``health`` event (the
    stream :class:`HealthMonitor` consumes as a hub sink). Returns
    ``(event, finite)`` — the fit loop uses ``finite`` to place its
    guard-skip step event AFTER any anomaly this emit produced, so the
    incident ring reads cause before effect."""
    from . import emit

    layers, loss, finite = stats_to_host(groups, hstate)
    event = emit("health", epoch=int(epoch), step=int(step), loss=loss,
                 finite=finite, stats=layers)
    return event, finite


def aggregate_events(events):
    """Per-layer aggregate over exported ``health``/``health_anomaly``
    events — the one table builder behind the ``telemetry health`` CLI:
    last + max gradient norm, last
    weight norm and update:weight ratio, summed nonfinite elements, and
    the anomaly count attributed to each layer."""
    def _fresh():
        return {"grad_norm": 0.0, "max_grad_norm": 0.0, "weight_norm": 0.0,
                "update_ratio": 0.0, "nonfinite": 0, "anomalies": 0}

    layers: dict = {}
    for e in events:
        kind = e.get("kind")
        if kind == "health":
            for layer, row in (e.get("stats") or {}).items():
                agg = layers.setdefault(layer, _fresh())
                agg["grad_norm"] = float(row.get("grad_norm", 0.0))
                agg["max_grad_norm"] = max(agg["max_grad_norm"],
                                           float(row.get("grad_norm", 0.0)))
                agg["weight_norm"] = float(row.get("weight_norm", 0.0))
                agg["update_ratio"] = float(row.get("update_ratio", 0.0))
                agg["nonfinite"] += int(row.get("nonfinite", 0))
        elif kind == "health_anomaly" and e.get("layer") is not None:
            layers.setdefault(e["layer"], _fresh())["anomalies"] += 1
    return layers


class _LayerTrack:
    __slots__ = ("ewma", "mad", "n", "dead_run")

    def __init__(self):
        self.ewma = None
        self.mad = 0.0
        self.n = 0
        self.dead_run = 0


class HealthMonitor:
    """Streaming anomaly detection over ``health`` events.

    Attach with :meth:`attach` (a kind-filtered hub sink — each health
    event costs one lock + O(layers) float math at emit time; no file
    parsing, no device access). Detection runs synchronously inside the
    emitting ``telemetry.emit("health", ...)`` call, so a ``health_
    anomaly`` incident always lands in the flight ring BEFORE whatever
    the emitter does next (the ordering the guard-skip post-mortem
    contract relies on). Thread-safe; the fleet controller reads
    :meth:`report`/:meth:`blamed_layer` from its own thread."""

    def __init__(self, config=None):
        self.cfg = config or HealthConfig()
        self._lock = named_lock("telemetry.health.HealthMonitor")
        self._layers: dict = {}          # layer -> _LayerTrack
        self._loss_ring = collections.deque(maxlen=self.cfg.window)
        self._loss_fast = None
        self._loss_slow = None
        self._drift_run = 0
        self._steps = 0
        self._last_stats = {}
        self._last_loss = None
        self._last_step = None
        self.anomalies = []              # bounded recent-anomaly list
        self._anomaly_marks = []         # aligned: _steps count at record
        self._anomaly_counts = collections.Counter()  # (layer, reason)
        self._attached = None

    # -- hub sink protocol -----------------------------------------------------
    def write_event(self, event):
        if event.get("kind") != "health":
            return
        self.observe(event)

    def feed(self, events):
        """Manual ingestion (tests / bench replay of an exported stream)."""
        for e in events:
            self.write_event(e)

    def attach(self, h=None):
        """Register as a kind-filtered sink (default: the process hub).
        Idempotent per hub; attaching to a DIFFERENT hub detaches from
        the previous one first (a monitor must never feed two hubs).
        Returns self."""
        from .hub import hub as _hub

        h = h or _hub()
        if self._attached is h:
            return self
        if self._attached is not None:
            self.detach()
        if not h.has_sink(self):
            h.add_sink(self, kinds=("health",))
        self._attached = h
        return self

    def detach(self):
        if self._attached is not None:
            self._attached.remove_sink(self)
            self._attached = None

    # -- detection -------------------------------------------------------------
    def observe(self, event):
        cfg = self.cfg
        stats = event.get("stats") or {}
        loss = event.get("loss")
        epoch = int(event.get("epoch", 0))
        step = int(event.get("step", 0))
        found = []
        with self._lock:
            self._steps += 1
            n_seen = self._steps
            self._last_stats = stats
            self._last_loss = loss
            self._last_step = (epoch, step)

            # loss spike: MAD z-score against the rolling window
            if loss is not None and math.isfinite(loss):
                ring = self._loss_ring
                if len(ring) >= cfg.min_steps:
                    vals = sorted(ring)
                    med = vals[len(vals) // 2]
                    mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
                    z = abs(loss - med) / (1.4826 * mad + 1e-12)
                    if z > cfg.loss_z:
                        found.append(("loss_spike", None, loss, cfg.loss_z,
                                      {"zscore": round(z, 2)}))
                ring.append(loss)
                # slow divergence drift: fast EWMA sustained above slow
                a_f, a_s = cfg.ewma_alpha, cfg.ewma_alpha / 8.0
                self._loss_fast = loss if self._loss_fast is None else \
                    (1 - a_f) * self._loss_fast + a_f * loss
                self._loss_slow = loss if self._loss_slow is None else \
                    (1 - a_s) * self._loss_slow + a_s * loss
                drifting = n_seen > cfg.min_steps and \
                    self._loss_fast > self._loss_slow * (1 + cfg.drift_tol)
                self._drift_run = self._drift_run + 1 if drifting else 0
                if self._drift_run == cfg.drift_steps:
                    found.append((
                        "divergence_drift", None, self._loss_fast,
                        cfg.drift_tol,
                        {"ewma_slow": round(self._loss_slow, 6),
                         "run_steps": self._drift_run}))
                    self._drift_run = 0

            step_finite = bool(event.get("finite", True))
            for layer, row in stats.items():
                track = self._layers.get(layer)
                if track is None:
                    track = self._layers[layer] = _LayerTrack()
                nonfinite = int(row.get("nonfinite", 0))
                gnorm = float(row.get("grad_norm", 0.0))
                ratio = float(row.get("update_ratio", 0.0))
                if nonfinite > 0 or not math.isfinite(gnorm):
                    found.append(("nonfinite", layer, nonfinite, 0,
                                  {"grad_norm": gnorm}))
                    continue  # a NaN norm must not poison the EWMA
                anomalous = False
                if gnorm > cfg.grad_limit:
                    found.append(("grad_explosion", layer, gnorm,
                                  cfg.grad_limit, {"absolute": True}))
                    anomalous = True
                elif track.n >= cfg.min_steps:
                    z = (gnorm - track.ewma) / (1.4826 * track.mad + 1e-12)
                    if z > cfg.grad_z:
                        found.append(("grad_explosion", layer, gnorm,
                                      cfg.grad_z, {"zscore": round(z, 2),
                                                   "ewma": track.ewma}))
                        anomalous = True
                if not anomalous:
                    # anomalous samples stay out of the baseline: repeated
                    # spikes must not normalize themselves away
                    a = cfg.ewma_alpha
                    if track.ewma is None:
                        track.ewma = gnorm
                    else:
                        track.mad = (1 - a) * track.mad + \
                            a * abs(gnorm - track.ewma)
                        track.ewma = (1 - a) * track.ewma + a * gnorm
                    track.n += 1
                # dead layer: ratio ~0 across consecutive OBSERVED finite
                # steps (guard-skipped steps write ratio 0 by construction
                # and must not count toward death)
                if step_finite and ratio < cfg.dead_ratio:
                    track.dead_run += 1
                    if track.dead_run == cfg.dead_steps:
                        found.append(("dead_layer", layer, ratio,
                                      cfg.dead_ratio,
                                      {"steps": cfg.dead_steps}))
                        track.dead_run = 0
                elif step_finite:
                    track.dead_run = 0
            for reason, layer, _v, _t, _x in found:
                self._anomaly_counts[(layer, reason)] += 1
        self._publish(event, stats, loss, found)
        return found

    def _publish(self, event, stats, loss, found):
        """Gauges + anomaly events OUTSIDE the detector lock (emit calls
        sinks; re-entering the hub while holding our lock would invert
        lock order against concurrent readers)."""
        from . import counter, emit, gauge

        cfg = self.cfg
        if cfg.gauges:
            if loss is not None:
                gauge("health_loss", loss)
            for layer, row in stats.items():
                gauge("health_grad_norm", row.get("grad_norm", 0.0),
                      layer=layer)
                gauge("health_weight_norm", row.get("weight_norm", 0.0),
                      layer=layer)
                gauge("health_update_ratio", row.get("update_ratio", 0.0),
                      layer=layer)
                gauge("health_nonfinite", row.get("nonfinite", 0),
                      layer=layer)
        for reason, layer, value, threshold, extra in found:
            counter("health_anomalies_total", reason=reason)
            rec = emit("health_anomaly", reason=reason, layer=layer,
                       epoch=event.get("epoch", 0),
                       step=event.get("step", 0),
                       value=value, threshold=threshold, **extra)
            with self._lock:
                self.anomalies.append(rec)
                # age is counted in OBSERVED steps (monotonic across
                # epochs — event step numbers reset per epoch and cannot
                # express "N healthy steps ago")
                self._anomaly_marks.append(self._steps)
                del self.anomalies[:-256]
                del self._anomaly_marks[:-256]

    # -- queries ---------------------------------------------------------------
    @property
    def steps_seen(self):
        with self._lock:
            return self._steps

    def blamed_layer(self, within_steps=None):
        """(layer, reason) of the most recent layer-attributed anomaly —
        the fleet controller's decision context — or None. ``within_
        steps`` bounds how stale a blame may be, counted in OBSERVED
        steps (monotonic across epochs; default: 2 windows)."""
        within = (2 * self.cfg.window if within_steps is None
                  else int(within_steps))
        with self._lock:
            for rec, mark in zip(reversed(self.anomalies),
                                 reversed(self._anomaly_marks)):
                if rec.get("layer") is None:
                    continue
                if self._steps - mark > within:
                    return None  # newest blame already aged out
                return rec["layer"], rec["reason"]
        return None

    def report(self):
        """Point-in-time health summary: last per-layer stats, per-layer
        anomaly counts, recent anomalies, steps observed."""
        with self._lock:
            layers = {}
            for layer, row in self._last_stats.items():
                counts = {r: c for (l, r), c in self._anomaly_counts.items()
                          if l == layer}
                layers[layer] = {**row, "anomalies": counts}
            return {
                "steps": self._steps,
                "loss": self._last_loss,
                "layers": layers,
                "anomalies": list(self.anomalies[-32:]),
                "anomaly_counts": {f"{l or '-'}/{r}": c for (l, r), c
                                   in sorted(self._anomaly_counts.items())},
            }

    def clear(self):
        with self._lock:
            self._layers.clear()
            self._loss_ring.clear()
            self._loss_fast = self._loss_slow = None
            self._drift_run = 0
            self._steps = 0
            self._last_stats = {}
            self._last_loss = None
            self._last_step = None
            self.anomalies = []
            self._anomaly_marks = []
            self._anomaly_counts.clear()
