"""The KVStore server role (reference: python/mxnet/kvstore_server.py, the
switch at import where a process with ``DMLC_ROLE`` other than worker runs
the server loop and exits inside ``import mxnet``).

Counterpart of ``mxnet_tpu/kvstore_server.py``. Synchronous data
parallelism has no server role here (the accumulate-at-server step is an
allreduce across the ranks), and the ``dist_async`` parameter host runs
inside worker rank 0 (``kvstore_async.py``). This module keeps the
surface for scripts that launch reference-style jobs:

  - ``KVStoreServer`` wraps the in-process BSP server of emulated worker
    groups (``kvstore.create_group``) and takes the reference's command
    transport, the pickled optimizer included (kvstore.py:231-256).
  - ``_init_srv_role`` is the switch at import: under
    ``DMLC_ROLE=server`` or ``scheduler`` (``tools/launch.py -s``) it logs
    that the role has nothing to do and exits cleanly, so reference
    launcher scripts still run: their server processes retire at once.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys

from .kvstore import _GroupServer

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """Controller around an in-process BSP server (reference:
    KVStoreServer._controller: kSyncMode, kStopServer, the optimizer)."""

    def __init__(self, server: _GroupServer):
        self.server = server
        self.sync_mode = True
        self._stopped = False

    def handle_command(self, head: int, body):
        """The reference's commands: 0 installs a pickled optimizer,
        kStopServer (-2) and kSyncMode (-3) control
        (kvstore_dist_server.h:22-23). Head -4 returns the server's
        counters: per-key BSP rounds, the duplicate pushes it absorbed,
        wire and raw bytes received, workers and keys."""
        if head == 0:
            from .kvstore import wrap_np_updater
            from .optimizer import get_updater

            optimizer = pickle.loads(body) \
                if isinstance(body, (bytes, bytearray)) else body
            self.server.updater = wrap_np_updater(get_updater(optimizer))
        elif head == -2:  # kStopServer
            self._stopped = True
        elif head == -3:  # kSyncMode
            self.sync_mode = True
        elif head == -4:
            with self.server.lock:
                return {"rounds": dict(self.server._round),
                        "duplicates": self.server.duplicate_count,
                        "wire_bytes_received":
                            self.server.wire_bytes_received,
                        "raw_bytes_received":
                            self.server.raw_bytes_received,
                        "num_workers": self.server.num_workers,
                        "keys": len(self.server.store)}
        return None

    def run(self):
        """The reference blocks here until kStopServer; this server is
        passive (the workers drive it), so it returns at once."""
        return


def _init_srv_role():
    role = os.environ.get("DMLC_ROLE", "worker")
    if role in ("server", "scheduler"):
        logging.warning(
            "DMLC_ROLE=%s: this role has nothing to do (dist_sync sums "
            "across the ranks, the dist_async host runs in worker 0); "
            "exiting cleanly.", role)
        sys.exit(0)


_init_srv_role()
