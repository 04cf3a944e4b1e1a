"""Generate ``mxnet_tpu_torch/bindings/r/mxtpu_generated.R``, the R binding's
op-wrapper layer, from the port's two registries: the counterpart of
``tools/gen_r_ops.py``, which writes ``R-package/R/mxtpu_generated.R`` from
the JAX package's.

Two sections, in the JAX script's format:
- mx.symbol.<Op> wrappers over mx.symbol.op() for every op in the Symbol
  registry (``ops/registry.py`` ``OPS``, the MXSymbolListAtomicSymbolCreators
  surface of the port's C API), with the op's docstring's first line as a
  comment;
- mx.nd.<func> wrappers over .mxr.func()/MXFuncInvoke for every registered
  NDArray function (``capi_support._FUNCTIONS``, the MXListFunctions
  surface), arity-aware: use-vars become ndarray-handle args, scalars
  become numeric args, the single mutate-var is an ``out`` argument.

  python -m mxnet_tpu_torch.tools.gen_r_ops           # rewrites the file
  python -m mxnet_tpu_torch.tools.gen_r_ops --check   # exit 1 when stale
"""

from __future__ import annotations

import os
import sys

from ..capi_support import _FUNCTIONS
from ..ops.registry import OPS

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bindings", "r", "mxtpu_generated.R")


def r_name(fname: str) -> str:
    """NDArray function name -> R surface name (reference convention:
    internal underscore names surface as mx.nd.<cleaned>)."""
    return fname.lstrip("_").replace("_", ".")


def render() -> tuple:
    """The file's text, the number of ops and of NDArray functions."""
    lines = [
        "# GENERATED by python -m mxnet_tpu_torch.tools.gen_r_ops -- do not",
        "# edit by hand. Wrappers for every registered operator + NDArray",
        "# function of mxnet_tpu_torch (R-package/R/mxtpu_generated.R is the",
        "# JAX package's). Regenerate: python -m",
        "# mxnet_tpu_torch.tools.gen_r_ops ; the tests assert exactness.",
        "",
        "# ------------------------- symbol operators (mx.symbol.<Op>)",
    ]
    seen = {}
    for cls in OPS._entries.values():
        # aliases share the class; internal _-prefixed ops stay off the R
        # surface (underscore-leading identifiers are not valid R names;
        # the reference's R layer exposed only the public set too)
        if cls.op_name[0].isalpha():
            seen.setdefault(cls.op_name, cls)
    for name in sorted(seen):
        prop = seen[name]
        doc = (getattr(prop, "__doc__", "") or "").strip().splitlines()
        if doc:
            lines.append(f"# {name}: {doc[0][:68]}")
        lines.append(
            f"mx.symbol.{name} <- function(...) mx.symbol.op(\"{name}\", ...)")
    lines.append("")
    lines.append("# ------------------- ndarray functions (mx.nd.<func>)")
    # hand-authored wrappers elsewhere carry semantics the generator can't
    # derive: optimizer.R's in-place defaults (out = first operand), and
    # ndarray.R's shape-changing outputs (dot's (m,k)x(k,n), norm's single
    # element); the generator must not clobber them
    hand_authored = {"_plus", "_minus", "_mul_scalar", "_copyto",
                     "dot", "norm"}
    # functions whose output shape equals the first operand's get an
    # OPTIONAL out (allocated via ndarray.R's .mxr.nd.alloc when absent),
    # so R expressions compose non-mutatingly: mx.nd.sqrt(mx.nd.square(a))
    shape_preserving = {"_div", "_mul", "_plus_scalar", "_minus_scalar",
                        "_div_scalar", "_rminus_scalar", "_rdiv_scalar",
                        "clip", "square", "sqrt", "exp", "log"}
    for fname in sorted(_FUNCTIONS.keys()):
        nuse, nscalar, nmutate, _ = _FUNCTIONS[fname]
        if nmutate != 1 or fname in hand_authored:
            continue  # R surface: single-output, non-hand-authored
        use_args = [f"a{i + 1}" for i in range(nuse)]
        sc_args = [f"s{i + 1}" for i in range(nscalar)]
        use_vec = (f"c({', '.join(use_args)})" if use_args else "integer(0)")
        sc_vec = (f"c({', '.join(sc_args)})" if sc_args else "numeric(0)")
        if fname in shape_preserving:
            args = use_args + sc_args + ["out = NULL"]
            alloc = ("  if (is.null(out)) "
                     "out <- .mxr.nd.alloc(mx.nd.shape(a1))\n")
        else:
            args = use_args + sc_args + ["out"]
            alloc = ""
        lines.append(
            f"mx.nd.{r_name(fname)} <- function({', '.join(args)}) {{\n"
            f"{alloc}"
            f"  .mxr.func(\"{fname}\", {use_vec}, {sc_vec}, out)\n"
            f"  out\n"
            f"}}")
    return "\n".join(lines) + "\n", len(seen), len(_FUNCTIONS)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    body, n_ops, n_funcs = render()
    if "--check" in argv:
        with open(OUT) as f:
            if f.read() != body:
                print("mxtpu_generated.R is STALE: run python -m "
                      "mxnet_tpu_torch.tools.gen_r_ops", file=sys.stderr)
                sys.exit(1)
        print("mxtpu_generated.R is current")
        return
    with open(OUT, "w") as f:
        f.write(body)
    print(f"wrote {os.path.normpath(OUT)} "
          f"({n_ops} ops, {n_funcs} nd functions)")


if __name__ == "__main__":
    main()
