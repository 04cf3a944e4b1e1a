"""The flat C API's library: ``mxtpu_capi.cc`` built at first use.

Counterpart of the JAX package's ``make capi`` target (its
``native/Makefile``). :func:`build_capi` compiles ``mxtpu_capi.cc`` (the
``MX*`` functions of ``mxtpu_c_api.h``, which forward to
``mxnet_tpu_torch.capi_support``) with the host's C++ compiler (``CXX``,
else ``g++``) into ``build/mxnet_tpu_torch/capi-<hash>/libmxtpu_torch_capi.so``
at the repository root and returns that path; the directory is named by a
hash of the sources, the flags and the Python it links, so a rebuild never
loads a stale library. Its file name and SONAME, ``libmxtpu_torch_capi.so``,
differ from the JAX package's ``libmxtpu_capi.so``: a host that links it
(``-L<dir> -lmxtpu_torch_capi``) resolves the port's library even in a
process that loaded both packages' libraries.

The library links libpython as the JAX package's Makefile does (``-L``,
``-rpath`` and ``-lpython<version>`` of the running interpreter) where that
interpreter is built with a shared libpython (``Py_ENABLE_SHARED``).
Without one it links no libpython: it then loads only into a running
Python (ctypes), whose symbols it uses, and an embedding C host cannot link
it. Loaded into a Python process the library joins that interpreter; in a
C host it starts one (``Py_InitializeEx``) at the first ``MX*`` call, which
imports the package from ``PYTHONPATH`` (:func:`embedding_env`).
"""

from __future__ import annotations

import hashlib
import os
import sys
import sysconfig
from pathlib import Path

from ..kernels._common import BUILD_DIR
from . import compile_cxx

__all__ = ["build_capi", "embedding_env", "LIB_NAME", "HEADER"]

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "mxtpu_capi.cc"
HEADER = _DIR / "mxtpu_c_api.h"
LIB_NAME = "libmxtpu_torch_capi.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             f"-Wl,-soname,{LIB_NAME}")


def _python_flags():
    """(include flags, link flags) of the running interpreter."""
    include = ("-I" + sysconfig.get_paths()["include"],)
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return include, ()
    libdir = sysconfig.get_config_var("LIBDIR")
    return include, (f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                     "-lpython" + sysconfig.get_config_var("LDVERSION"))


def build_capi() -> Path:
    """The C API library's path, built now if needed; raises ``MXNetError``
    with the compiler's output when the build fails."""
    include, link = _python_flags()
    flags = CXX_FLAGS + include
    key = b"\0".join([SOURCE.read_bytes(), HEADER.read_bytes(),
                      " ".join(flags + link).encode(), sys.version.encode()])
    out = BUILD_DIR / f"capi-{hashlib.sha256(key).hexdigest()[:16]}" / LIB_NAME
    return compile_cxx(SOURCE, out, flags, link)


def embedding_env(env=None) -> dict:
    """``env`` (default: this process's environment) with ``PYTHONPATH``
    and ``PYTHONHOME`` set so that a C host started with it, which embeds
    Python through the library, finds this interpreter's standard library,
    its site-packages and the package."""
    env = dict(os.environ if env is None else env)
    root = str(Path(__file__).resolve().parents[2])
    paths = [root] + [p for p in sys.path if p and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    env["PYTHONHOME"] = os.pathsep.join((sys.base_prefix,
                                         sys.base_exec_prefix))
    return env
