"""Sharded checkpoints with atomic commit, and the single-file helpers.

Counterpart of ``mxnet_tpu/utils/checkpoint.py``, with its eight public
names. A step is written into a hidden ``.tmp.<step>`` directory and made
visible by one ``os.rename``. It holds ``state/``, ``symbol.json``,
``manifest.json`` (format 1: the size and CRC32 of every file but the
manifest and the metadata) and ``metadata.json`` (``{"step": ...}`` plus the
caller's keys). ``validate_step`` checks a step against its manifest
(``MXNET_TPU_CKPT_VERIFY``: ``crc``, the default, ``size`` or ``off``),
``latest_step`` skips torn and corrupt steps with a warning, and
``prune_steps`` renames a victim to ``.gc.<step>`` before deleting it. These
three read only manifests and metadata, so they give the JAX package's
answers on either package's directories.

The JAX package writes ``state/`` as orbax OCDBT, which needs tensorstore to
read. The port writes one ``.npy`` per leaf instead:
``state/params/<name>.npy``, ``state/aux/<name>.npy``, ``state/opt/<i>.npy``
(the optimizer state's leaves in the JAX package's flattening order) and
``state/comm/<name>.npy``. :func:`load_sharded` reads that layout; on an
OCDBT step it raises, naming the layout. One process writes every leaf:
the port's training keeps whole tensors on each rank.

:func:`atomic_write` and :func:`check_sidecar` are the single-file format's
discipline (``save_checkpoint``'s ``.params`` and its ``.crc32`` sidecar).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import zlib

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save_sharded", "load_sharded", "load_resharded", "latest_step",
           "validate_step", "prune_steps", "atomic_write", "check_sidecar"]

_STATE_DIR = "state"
_SYMBOL_FILE = "symbol.json"
_META_FILE = "metadata.json"
_MANIFEST_FILE = "manifest.json"
_TMP_PREFIX = ".tmp."
_GC_PREFIX = ".gc."
_GROUPS = ("params", "aux", "opt", "comm")


def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _write_manifest(step_dir, step):
    """Record the size and CRC32 of every file of the step directory but
    the manifest and the metadata; returns the bytes manifested."""
    files, total = {}, 0
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for name in sorted(filenames):
            if name in (_MANIFEST_FILE, _META_FILE):
                continue
            full = os.path.join(dirpath, name)
            size = os.path.getsize(full)
            files[os.path.relpath(full, step_dir)] = {
                "size": size, "crc32": _file_crc32(full)}
            total += size
    with open(os.path.join(step_dir, _MANIFEST_FILE), "w") as f:
        json.dump({"format": 1, "step": int(step), "files": files}, f)
    return total


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _write_group(root, group, values: dict):
    folder = os.path.join(root, group)
    os.makedirs(folder, exist_ok=True)
    for name, value in values.items():
        np.save(os.path.join(folder, f"{name}.npy"), _host(value),
                allow_pickle=False)


def _read_group(root, group):
    folder = os.path.join(root, group)
    if not os.path.isdir(folder):
        return None
    return {name[:-4]: np.load(os.path.join(folder, name), allow_pickle=False)
            for name in sorted(os.listdir(folder)) if name.endswith(".npy")}


def _chaos_corrupt(step_dir):
    """The ``ckpt.corrupt`` chaos site: when it fires, flip 64 bytes in
    the middle of the first (sorted) state shard, after the manifest was
    written, so validation must catch it
    (mxnet_tpu/utils/checkpoint.py:88-112)."""
    from ..resilience import chaos

    if not chaos.fires("ckpt.corrupt"):
        return
    victims = sorted(
        os.path.join(dirpath, name)
        for dirpath, _d, names in os.walk(os.path.join(step_dir, _STATE_DIR))
        for name in names if os.path.getsize(os.path.join(dirpath, name)))
    if not victims:
        return
    victim = victims[0]
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(min(64, size - size // 2))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    logging.warning("chaos: corrupted checkpoint shard %s", victim)


def save_sharded(directory, step, params, aux=None, symbol=None,
                 extra_meta=None, opt_state=None, comm_state=None,
                 tier="t2"):
    """Atomically write checkpoint ``step`` under ``directory`` and return
    its path. ``opt_state`` is the flat list of optimizer-state leaves
    (:func:`mxnet_tpu_torch.model.opt_leaves`); ``comm_state`` a dict of
    gradient-sync state. Tensors are copied to the host here. Everything
    lands in ``.tmp.<step>`` first; the rename is the commit, so a crash
    before it leaves the earlier steps as they were. The save runs in the
    telemetry phase ``checkpoint_save`` and counts ``checkpoint_saves_total``
    and ``ckpt_bytes_written``; a ``checkpoint`` event names ``tier``
    (mxnet_tpu/utils/checkpoint.py:135-147)."""
    from .. import telemetry

    t0 = telemetry.hub().now()
    with telemetry.phase("checkpoint_save"):
        out = _save_sharded(directory, step, params, aux=aux, symbol=symbol,
                            extra_meta=extra_meta, opt_state=opt_state,
                            comm_state=comm_state)
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(out) for f in files)
    telemetry.counter("checkpoint_saves_total")
    if nbytes:
        telemetry.counter("ckpt_bytes_written", float(nbytes))
    telemetry.emit("checkpoint", step=int(step),
                   seconds=telemetry.hub().now() - t0, tier=str(tier))
    return out


def _save_sharded(directory, step, params, aux=None, symbol=None,
                  extra_meta=None, opt_state=None, comm_state=None):
    directory = os.path.abspath(os.fspath(directory))
    os.makedirs(directory, exist_ok=True)
    step = int(step)
    step_dir = os.path.join(directory, str(step))
    tmp_dir = os.path.join(directory, f"{_TMP_PREFIX}{step}")
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)  # left by a crashed earlier attempt
    state_dir = os.path.join(tmp_dir, _STATE_DIR)
    os.makedirs(state_dir)
    _write_group(state_dir, "params", dict(params))
    if aux:
        _write_group(state_dir, "aux", dict(aux))
    if opt_state is not None:
        _write_group(state_dir, "opt",
                     {str(i): v for i, v in enumerate(opt_state)})
    if comm_state is not None:
        _write_group(state_dir, "comm", dict(comm_state))
    if symbol is not None:
        symbol.save(os.path.join(tmp_dir, _SYMBOL_FILE))
    _write_manifest(tmp_dir, step)
    meta = {"step": step}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp_dir, _META_FILE), "w") as f:
        json.dump(meta, f)
    _chaos_corrupt(tmp_dir)
    if os.path.exists(step_dir):
        # overwrite: the old step moves aside for the rename; a kill in this
        # window loses this step only, and validation skips its leftovers
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def validate_step(directory, step, verify=None):
    """Is checkpoint ``step`` complete and uncorrupted? ``verify``:
    ``"crc"`` (default, from ``MXNET_TPU_CKPT_VERIFY``), ``"size"`` or
    ``"off"``. A step without a manifest (written before the format had
    one) passes when ``state/`` and ``metadata.json`` are present."""
    verify = verify or os.environ.get("MXNET_TPU_CKPT_VERIFY", "crc")
    step_dir = os.path.join(os.path.abspath(os.fspath(directory)),
                            str(int(step)))
    meta_path = os.path.join(step_dir, _META_FILE)
    if not os.path.isdir(os.path.join(step_dir, _STATE_DIR)) or \
            not os.path.exists(meta_path):
        return False
    try:
        with open(meta_path) as f:
            json.load(f)
    except (OSError, ValueError):
        return False  # torn metadata write
    if verify == "off":
        return True
    manifest_path = os.path.join(step_dir, _MANIFEST_FILE)
    if not os.path.exists(manifest_path):
        return True  # a step from before the manifest: presence is all
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        for rel, info in manifest["files"].items():
            full = os.path.join(step_dir, rel)
            if os.path.getsize(full) != info["size"]:
                return False
            if verify == "crc" and _file_crc32(full) != info["crc32"]:
                return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def _steps(directory):
    return sorted((int(d) for d in os.listdir(directory) if d.isdigit()),
                  reverse=True)


def latest_step(directory, verify=None):
    """The highest step that validates, or None. Torn and corrupt steps are
    skipped with a warning, so a resume lands on the newest checkpoint that
    loads."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    for step in _steps(directory):
        if validate_step(directory, step, verify=verify):
            return step
        logging.warning(
            "checkpoint step %d under %s is incomplete or corrupt; "
            "skipping it for resume", step, directory)
    return None


def load_sharded(directory, step=None, shardings=None, with_comm=False):
    """``(params, aux, symbol, meta, opt_leaves)`` of a checkpoint (the
    newest valid one when ``step`` is None), as host numpy arrays;
    ``opt_leaves`` is the flat list of optimizer-state leaves or None.
    ``with_comm=True`` appends the saved gradient-sync state (or None).
    ``shardings`` places arrays on a JAX mesh in the JAX package; the port
    has no such placement and takes None only. A step written as orbax
    OCDBT (the JAX package's layout) raises."""
    if shardings is not None:
        raise MXNetError("load_sharded(shardings=...) places arrays on a JAX "
                         "mesh; the port loads host arrays (shardings=None)")
    directory = os.path.abspath(os.fspath(directory))
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    step_dir = os.path.join(directory, str(int(step)))
    state_dir = os.path.join(step_dir, _STATE_DIR)
    groups = {g: _read_group(state_dir, g) for g in _GROUPS}
    if groups["params"] is None:
        found = sorted(os.listdir(state_dir)) if os.path.isdir(state_dir) \
            else []
        layout = "orbax OCDBT (the JAX package's layout)" \
            if any("ocdbt" in name or name.startswith("_") for name in found) \
            else f"unknown ({found[:6]})"
        raise MXNetError(
            f"checkpoint {step_dir}: state/ is {layout}; the port reads its "
            "own layout, one .npy per leaf under state/params, aux, opt "
            "and comm (carry the arrays across with the JAX package's "
            "load_sharded and this module's save_sharded)")
    opt = groups["opt"]
    opt_leaves = None if opt is None else \
        [opt[k] for k in sorted(opt, key=int)]
    symbol = None
    sym_path = os.path.join(step_dir, _SYMBOL_FILE)
    if os.path.exists(sym_path):
        from ..symbol import load as sym_load

        symbol = sym_load(sym_path)
    meta = {}
    meta_path = os.path.join(step_dir, _META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    out = (groups["params"], groups["aux"] or {}, symbol, meta, opt_leaves)
    return out + (groups["comm"],) if with_comm else out


def load_resharded(directory, mesh, step=None):
    """The JAX package restores onto a new data-parallel mesh here (elastic
    resize). The port's ranks hold whole tensors, so this is
    :func:`load_sharded` with the gradient-sync state; ``mesh`` is accepted
    for the signature and not read."""
    del mesh
    return load_sharded(directory, step, with_comm=True)


def prune_steps(directory, keep_last_k, verify=None):
    """Delete the steps older than the ``keep_last_k`` newest valid ones;
    returns the pruned step ids. A victim is renamed to ``.gc.<step>``
    (out of the scan, in one atomic step) before it is deleted, so a
    concurrent ``latest_step`` sees it whole or not at all. Steps newer than
    the k-th valid one, torn or not, are never touched."""
    directory = os.path.abspath(os.fspath(directory))
    keep_last_k = int(keep_last_k)
    if keep_last_k <= 0 or not os.path.isdir(directory):
        return []
    steps = _steps(directory)
    valid = [s for s in steps if validate_step(directory, s, verify=verify)]
    if len(valid) <= keep_last_k:
        return []
    cutoff = valid[keep_last_k - 1]
    pruned = []
    for step in steps:
        if step >= cutoff:
            continue
        trash = os.path.join(directory, f"{_GC_PREFIX}{step}")
        try:
            os.rename(os.path.join(directory, str(step)), trash)
            shutil.rmtree(trash, ignore_errors=True)
            pruned.append(step)
        except OSError:
            continue
    # left by a pruner killed between rename and delete
    for d in os.listdir(directory):
        if d.startswith(_GC_PREFIX):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return pruned


def atomic_write(path, writer):
    """Write ``path`` through ``writer(tmp_path)`` at a hidden temporary
    name, record a ``<path>.crc32`` sidecar (``{"size", "crc32"}``) and
    commit both with ``os.replace``, file first: a kill between the two
    leaves a stale sidecar that load reports as corruption. Returns the
    absolute path."""
    path = os.path.abspath(os.fspath(path))
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f"{_TMP_PREFIX}{os.path.basename(path)}")
    writer(tmp)
    info = {"size": os.path.getsize(tmp), "crc32": _file_crc32(tmp)}
    side_tmp = tmp + ".crc32"
    with open(side_tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    os.replace(side_tmp, path + ".crc32")
    return path


def check_sidecar(path):
    """True when ``path`` matches its CRC sidecar, False when it does not
    (torn or corrupt), None when there is no sidecar (accepted as it is)."""
    path = os.path.abspath(os.fspath(path))
    side = path + ".crc32"
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            info = json.load(f)
        return (os.path.getsize(path) == int(info["size"])
                and _file_crc32(path) == int(info["crc32"]))
    except (OSError, ValueError, KeyError, TypeError):
        return False
