"""Network visualization.

Counterpart of ``mxnet_tpu/visualization.py`` (reference:
python/mxnet/visualization.py): ``plot_network`` returns the graph as DOT
source, with no graphviz import, and can write it to a file;
``print_summary`` prints a table of each layer's output shape and parameter
count. Both produce the JAX package's text for the same symbol.
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["plot_network", "print_summary"]

_NODE_STYLE = {
    "FullyConnected": ("#fb8072", lambda op: f"FullyConnected\\n{op.num_hidden}"),
    "Convolution": ("#fb8072", lambda op: f"Convolution\\n{op.kernel}/{op.stride}, {op.num_filter}"),
    "Deconvolution": ("#fb8072", lambda op: f"Deconvolution\\n{op.kernel}/{op.stride}, {op.num_filter}"),
    "Activation": ("#ffffb3", lambda op: f"Activation\\n{op.act_type}"),
    "LeakyReLU": ("#ffffb3", lambda op: f"LeakyReLU\\n{op.act_type}"),
    "Pooling": ("#80b1d3", lambda op: f"Pooling\\n{op.pool_type}, {op.kernel}/{op.stride}"),
    "Concat": ("#fdb462", lambda op: "Concat"),
    "BatchNorm": ("#bebada", lambda op: "BatchNorm"),
    "SoftmaxOutput": ("#fccde5", lambda op: "Softmax"),
}


def plot_network(symbol, title="plot", shape=None, save_path=None):
    """The symbol's DAG as DOT source (reference: viz.plot_network)."""
    del shape
    nodes = symbol._topo()
    nid = {id(n): i for i, n in enumerate(nodes)}
    lines = [f'digraph "{title}" {{', "  rankdir=BT;",
             '  node [shape=box, style=filled, fontsize=10];']
    for n in nodes:
        if n.is_variable:
            lines.append(
                f'  n{nid[id(n)]} [label="{n.name}", fillcolor="#8dd3c7"];')
        else:
            color, labeler = _NODE_STYLE.get(
                n.op.name, ("#d9d9d9", lambda op: op.name))
            lines.append(f'  n{nid[id(n)]} [label="{n.name}\\n'
                         f'{labeler(n.op)}", fillcolor="{color}"];')
    for n in nodes:
        for src, _idx in n.inputs:
            lines.append(f"  n{nid[id(src)]} -> n{nid[id(n)]};")
    lines.append("}")
    dot = "\n".join(lines)
    if save_path:
        with open(save_path, "w") as f:
            f.write(dot)
    return dot


def print_summary(symbol, shape=None, line_length=98):
    """Print and return a text table of each layer's name and type, output
    shape and parameter count; ``shape`` gives the input shapes."""
    if shape is None:
        raise MXNetError("print_summary requires input shapes, e.g. "
                         "shape={'data': (1,3,224,224)}")
    arg_shapes, _, _ = symbol.infer_shape(**shape)
    shape_of = dict(zip(symbol.list_arguments(), arg_shapes))
    total_params = 0
    out = [f"{'Layer (type)':<40}{'Output Shape':<30}{'Param #':<15}",
           "=" * line_length]
    known = {}
    for n in symbol._topo():
        if n.is_variable:
            known[(id(n), 0)] = shape_of.get(n.name)
            continue
        ins = [known.get((id(s), i)) for s, i in n.inputs]
        _, outs, _ = n.op.infer_shape(ins)
        for i, s in enumerate(outs):
            known[(id(n), i)] = s
        params = 0
        for s, _i in n.inputs:
            if s.is_variable and s.name != "data" \
                    and not s.name.endswith("label"):
                sh = shape_of.get(s.name)
                if sh:
                    cnt = 1
                    for d in sh:
                        cnt *= d
                    params += cnt
        total_params += params
        out.append(f"{n.name + ' (' + n.op.name + ')':<40}"
                   f"{str(outs[0]):<30}{params:<15}")
    out.append("=" * line_length)
    out.append(f"Total params: {total_params}")
    text = "\n".join(out)
    print(text)
    return text
