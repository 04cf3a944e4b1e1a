"""Stream IO over local paths and ``scheme://`` URIs.

Counterpart of ``mxnet_tpu/filesystem.py``: plain paths and ``file://``
open with the builtin ``open``; any other scheme goes through ``fsspec``,
and a missing driver raises an ``MXNetError`` that names it. RecordIO,
``ImageRecordIter``, ``MNISTIter`` and ``CSVIter`` read through
:func:`open_uri`.
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["open_uri", "is_remote_uri"]


def is_remote_uri(uri: str) -> bool:
    """True for a ``scheme://`` URI other than ``file://``."""
    return "://" in uri and not uri.startswith("file://")


def open_uri(uri: str, mode: str = "rb"):
    """Open a local path or a ``scheme://`` URI for streaming."""
    if not is_remote_uri(uri):
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        return open(path, mode)
    try:
        import fsspec
    except ImportError as e:
        raise MXNetError(
            f"opening {uri!r} needs fsspec for remote filesystems") from e
    try:
        return fsspec.open(uri, mode).open()
    except (ImportError, ValueError) as e:  # missing driver, unknown scheme
        raise MXNetError(
            f"cannot open {uri!r}: {e} "
            "(install the fsspec extra for this scheme, e.g. s3fs/gcsfs)"
        ) from e
