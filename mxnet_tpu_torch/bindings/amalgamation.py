#!/usr/bin/env python3
"""Amalgamation: emit the native predictor as ONE self-contained C++ file.

Counterpart of the JAX package's ``amalgamation/amalgamation.py``
(reference: amalgamation/amalgamation.py, which inlines every project
header into a single ``mxnet_predict-all.cc`` so the CPU predict path
builds anywhere with ``g++ one_file.cc``, external deps reduced to a
whitelist: there BLAS, here zlib). Its default source is the port's
``native/mxtpu_predict.cc`` and its default output
``build/mxnet_tpu_torch/mxtpu_predict-all.cc`` at the repository root.

Algorithm: walk the translation unit, inline local (``"..."``) includes
exactly once, keep system (``<...>``) includes deduplicated at the top,
refuse includes outside the whitelist, stamp a provenance banner.

Usage:
    python -m mxnet_tpu_torch.bindings.amalgamation [-o OUT.cc] [--compile]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
DEFAULT_SOURCE = os.path.join(_PKG, "native", "mxtpu_predict.cc")
DEFAULT_OUTPUT = os.path.join(ROOT, "build", "mxnet_tpu_torch",
                              "mxtpu_predict-all.cc")

# External headers the single file may keep (everything else must inline).
# C++ stdlib headers are always allowed; this lists the non-stdlib ones.
SYSTEM_WHITELIST = {"zlib.h", "pthread.h"}

_STDLIB = re.compile(r"^[a-z_]+$")  # <vector>, <cstring>, ... (no dot)
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^">]+)[">]')


def _inline(path, seen, system_includes, out_lines):
    if path in seen:
        return
    seen.add(path)
    rel = os.path.relpath(path, ROOT)
    out_lines.append(f"// ===== begin {rel} =====\n")
    with open(path) as f:
        for line in f:
            m = _INCLUDE.match(line)
            if not m:
                out_lines.append(line)
                continue
            kind, header = m.groups()
            if kind == "<":
                if not (_STDLIB.match(header) or header in SYSTEM_WHITELIST):
                    raise SystemExit(
                        f"{rel}: system include <{header}> is not in the "
                        f"amalgamation whitelist {sorted(SYSTEM_WHITELIST)}")
                system_includes.append(header)
            else:
                local = os.path.join(os.path.dirname(path), header)
                if not os.path.exists(local):
                    raise SystemExit(f"{rel}: local include {header!r} not found")
                _inline(local, seen, system_includes, out_lines)
    out_lines.append(f"// ===== end {rel} =====\n")


def amalgamate(source=DEFAULT_SOURCE, output=None):
    """Produce the single-file source; returns the output path."""
    output = output or DEFAULT_OUTPUT
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    system_includes, body, seen = [], [], set()
    _inline(source, seen, system_includes, body)
    dedup = list(dict.fromkeys(system_includes))
    with open(output, "w") as f:
        f.write("// mxtpu_predict-all.cc — generated by "
                "mxnet_tpu_torch/bindings/amalgamation.py. DO NOT EDIT.\n"
                "// Single-file native predictor: build with\n"
                "//   g++ -O3 -std=c++17 -shared -fPIC "
                "mxtpu_predict-all.cc -lz -o libmxtpu_predict.so\n"
                "// or add -DMXTPU_PREDICT_MAIN for the standalone CLI.\n\n")
        for header in dedup:
            f.write(f"#include <{header}>\n")
        f.write("\n")
        for line in body:
            if not _INCLUDE.match(line):
                f.write(line)
    return os.path.abspath(output)


def compile_check(path, shared=True):
    """g++-compile the amalgamated file; returns the artifact path."""
    out = path.replace(".cc", ".so" if shared else "")
    cmd = ["g++", "-O2", "-std=c++17", "-Wall", path, "-lz", "-o", out]
    if shared:
        cmd[1:1] = ["-shared", "-fPIC"]
    else:
        cmd[1:1] = ["-DMXTPU_PREDICT_MAIN"]
    subprocess.run(cmd, check=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--compile", action="store_true",
                    help="also build the shared library from the output")
    args = ap.parse_args()
    out = amalgamate(output=args.output)
    with open(out) as f:
        print(f"wrote {out} ({sum(1 for _ in f)} lines)")
    if args.compile:
        so = compile_check(out)
        print(f"built {so}")


if __name__ == "__main__":
    main()
