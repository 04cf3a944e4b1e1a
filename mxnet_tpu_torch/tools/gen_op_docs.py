"""Generate the port's operator reference page, ``mxnet_tpu_torch/doc/ops.md``,
from its operator registry: the counterpart of ``tools/gen_op_docs.py``,
which renders the JAX package's registry into ``doc/python/ops.md``.

Every operator's parameters are declared once as typed specs on its OpProp
and rendered here in the JAX script's format. The summaries are the port's
own docstrings; the operators, aliases, parameter names, types and defaults
are the JAX package's, apart from Deconvolution's ``adj`` and
``target_shape``, which the port has beyond it.

  python -m mxnet_tpu_torch.tools.gen_op_docs     # rewrites doc/ops.md
"""

from __future__ import annotations

import os

from ..ops.registry import OPS, REQUIRED

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "doc", "ops.md")


def _fmt_default(spec):
    default = spec[1]
    if default is REQUIRED:
        return "**required**"
    return f"`{default!r}`"


def _fmt_type(t):
    if isinstance(t, tuple):  # enum of choices
        return " \\| ".join(f"`{c}`" for c in t)
    return f"`{getattr(t, '__name__', t)}`"


def render() -> tuple:
    """The page's text and the number of operators on it."""
    classes = {}
    for cls in OPS._entries.values():
        classes[cls.op_name] = cls

    lines = [
        "# Operator reference",
        "",
        "<!-- GENERATED by python -m mxnet_tpu_torch.tools.gen_op_docs —",
        "edit the operator param specs (mxnet_tpu_torch/ops/*.py), not this",
        "file. -->",
        "",
        "Every operator's parameters are declared once as typed specs on its",
        "OpProp (the dmlc::Parameter equivalent, `mxnet_tpu_torch/params.py`)",
        "and surfaced identically in Python docstrings (`help(mt.symbol.X)`),",
        "the C API (`MXSymbolGetAtomicSymbolInfo`), and this page.",
        "",
    ]
    for name in sorted(classes):
        cls = classes[name]
        doc = (cls.__doc__ or "").strip()
        # first paragraph, joined (single lines truncate mid-sentence)
        summary = " ".join(
            line.strip() for line in doc.split("\n\n")[0].splitlines())
        lines += [f"## {name}", ""]
        if summary:
            lines += [summary, ""]
        aliases = [a for a in getattr(cls, "op_aliases", ()) if a]
        if aliases:
            lines += ["Aliases: " + ", ".join(f"`{a}`" for a in aliases), ""]
        params = getattr(cls, "params", {})
        if params:
            lines += ["| parameter | type | default | description |",
                      "|---|---|---|---|"]
            for pname, spec in params.items():
                desc = spec[2] if len(spec) > 2 else ""
                lines.append(f"| `{pname}` | {_fmt_type(spec[0])} | "
                             f"{_fmt_default(spec)} | {desc} |")
            lines.append("")
        else:
            lines += ["No parameters.", ""]
    return "\n".join(lines), len(classes)


def main():
    text, count = render()
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT} ({count} operators)")


if __name__ == "__main__":
    main()
