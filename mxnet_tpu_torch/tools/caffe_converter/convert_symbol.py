"""prototxt → Symbol, the port's counterpart of
``tools/caffe_converter/convert_symbol.py``.

Maps the same layer set — Convolution, Pooling, ReLU, LRN, InnerProduct,
Dropout, Softmax(WithLoss), Flatten, Split, Concat, plus Sigmoid, TanH and
Eltwise — onto the port's Symbol API, node for node as the JAX package's
converter does, so both give one graph. Layer names become symbol names,
so converted weights land on ``{layer}_weight`` / ``{layer}_bias``
argument names.

    python -m mxnet_tpu_torch.tools.caffe_converter.convert_symbol \
        net.prototxt net-symbol.json
"""

from __future__ import annotations

import mxnet_tpu_torch as mx

from .prototxt import first, parse

__all__ = ["proto_to_symbol"]

# V1LayerParameter enum values accepted alongside type strings, matching the
# reference's dual string/number checks (convert_symbol.py:42-95)
_V1_TYPES = {3: "Concat", 4: "Convolution", 5: "Data", 6: "Dropout",
             8: "Flatten", 14: "InnerProduct", 15: "LRN", 17: "Pooling",
             18: "ReLU", 19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss",
             22: "Split", 23: "TanH", 1: "Accuracy", 25: "Eltwise"}

_SKIP_TYPES = {"Accuracy", "Data", "ImageData", "HDF5Data", "Input"}


def _pair(param, key, default):
    """Caffe's kernel/stride/pad: repeated single value or _h/_w split."""
    h = first(param, f"{key}_h")
    w = first(param, f"{key}_w")
    if h is not None or w is not None:
        return (int(h or default), int(w or default))
    v = first(param, key if key != "kernel" else "kernel_size")
    if v is None:
        return (default, default)
    return (int(v), int(v))


def _get_inputs(net, blobs):
    """Register net inputs: `input:`+`input_dim`/`input_shape`, or Input/Data
    layers. Returns {input_name: shape or None}."""
    shapes = {}
    names = [n for n in net.get("input", [])]
    dims = [int(d) for d in net.get("input_dim", [])]
    in_shapes = net.get("input_shape", [])
    for i, name in enumerate(names):
        if dims:
            shapes[name] = tuple(dims[4 * i: 4 * i + 4])
        elif i < len(in_shapes):
            shapes[name] = tuple(int(d) for d in in_shapes[i].get("dim", []))
        else:
            shapes[name] = None
        blobs[name] = mx.sym.Variable(name)
    return shapes


def proto_to_symbol(text_or_path):
    """Convert a prototxt (path or text) to ``(symbol, input_shapes)``.

    ``symbol`` is the net's final head (or a Group of all unconsumed heads);
    ``input_shapes`` maps declared input names to shapes (or None).
    """
    text = text_or_path
    if "\n" not in text_or_path and not text_or_path.lstrip().startswith(
            ("name", "input", "layer")):
        with open(text_or_path) as f:
            text = f.read()
    net = parse(text)

    blobs = {}  # blob (top) name -> Symbol
    input_shapes = _get_inputs(net, blobs)
    consumed = set()

    layers = list(net.get("layer", [])) + list(net.get("layers", []))
    for layer in layers:
        ltype = first(layer, "type")
        ltype = _V1_TYPES.get(ltype, ltype)
        name = first(layer, "name")
        bottoms = [b for b in layer.get("bottom", []) if b != "label"]
        tops = layer.get("top", [name])

        if ltype in _SKIP_TYPES:
            for top in tops:
                if top != "label" and top not in blobs:
                    blobs[top] = mx.sym.Variable(top)
                    input_shapes.setdefault(top, None)
            continue

        ins = []
        for b in bottoms:
            if b not in blobs:
                blobs[b] = mx.sym.Variable(b)
                input_shapes.setdefault(b, None)
            ins.append(blobs[b])
            consumed.add(b)
        data = ins[0] if ins else None

        if ltype == "Convolution":
            p = first(layer, "convolution_param", {})
            out = mx.sym.Convolution(
                data=data, name=name,
                num_filter=int(first(p, "num_output")),
                kernel=_pair(p, "kernel", 1),
                stride=_pair(p, "stride", 1),
                pad=_pair(p, "pad", 0),
                num_group=int(first(p, "group", 1)),
                no_bias=not first(p, "bias_term", True))
        elif ltype == "Pooling":
            p = first(layer, "pooling_param", {})
            pool = first(p, "pool", "MAX")
            pool_type = {"MAX": "max", 0: "max", "AVE": "avg",
                         1: "avg"}.get(pool, "max")
            if first(p, "global_pooling", False):
                out = mx.sym.Pooling(data=data, name=name, kernel=(1, 1),
                                     pool_type=pool_type, global_pool=True)
            else:
                out = mx.sym.Pooling(
                    data=data, name=name, pool_type=pool_type,
                    kernel=_pair(p, "kernel", 1),
                    stride=_pair(p, "stride", 1),
                    pad=_pair(p, "pad", 0))
        elif ltype in ("ReLU", "Sigmoid", "TanH"):
            act = {"ReLU": "relu", "Sigmoid": "sigmoid", "TanH": "tanh"}[ltype]
            out = mx.sym.Activation(data=data, name=name, act_type=act)
        elif ltype == "LRN":
            p = first(layer, "lrn_param", {})
            out = mx.sym.LRN(data=data, name=name,
                             nsize=int(first(p, "local_size", 5)),
                             alpha=float(first(p, "alpha", 1.0)),
                             beta=float(first(p, "beta", 0.75)),
                             knorm=float(first(p, "k", 1.0)))
        elif ltype == "InnerProduct":
            p = first(layer, "inner_product_param", {})
            flat = mx.sym.Flatten(data=data, name=f"{name}_flatten")
            out = mx.sym.FullyConnected(
                data=flat, name=name,
                num_hidden=int(first(p, "num_output")),
                no_bias=not first(p, "bias_term", True))
        elif ltype == "Dropout":
            p = first(layer, "dropout_param", {})
            out = mx.sym.Dropout(data=data, name=name,
                                 p=float(first(p, "dropout_ratio", 0.5)))
        elif ltype in ("Softmax", "SoftmaxWithLoss"):
            out = mx.sym.SoftmaxOutput(data=data, name=name)
        elif ltype == "Flatten":
            out = mx.sym.Flatten(data=data, name=name)
        elif ltype == "Concat":
            p = first(layer, "concat_param", {})
            out = mx.sym.Concat(*ins, name=name,
                                dim=int(first(p, "axis", 1)))
        elif ltype == "Eltwise":
            p = first(layer, "eltwise_param", {})
            op = first(p, "operation", "SUM")
            if op not in ("SUM", 1):
                raise ValueError(f"Eltwise operation {op!r} not supported")
            out = mx.sym.ElementWiseSum(*ins, name=name)
        elif ltype == "Split":
            out = data  # split = fan-out; every top aliases the input symbol
        else:
            raise ValueError(f"unknown layer type {ltype!r} ({name})")

        for top in tops:
            blobs[top] = out

    heads = [s for top, s in blobs.items()
             if top not in consumed and top not in input_shapes]
    if not heads:
        raise ValueError("net has no output heads")
    # dedup aliased heads (Split) preserving order
    uniq = []
    for h in heads:
        if all(h is not u for u in uniq):
            uniq.append(h)
    symbol = uniq[0] if len(uniq) == 1 else mx.sym.Group(uniq)
    return symbol, input_shapes


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="prototxt -> symbol JSON")
    ap.add_argument("prototxt")
    ap.add_argument("output_json")
    args = ap.parse_args(argv)
    symbol, shapes = proto_to_symbol(args.prototxt)
    symbol.save(args.output_json)
    print(f"saved {args.output_json}; inputs: {shapes}")


if __name__ == "__main__":
    main()
