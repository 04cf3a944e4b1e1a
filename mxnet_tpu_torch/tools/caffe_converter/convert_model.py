"""Caffe weights → arg_params, the port's counterpart of
``tools/caffe_converter/convert_model.py``.

A ``.caffemodel`` is read through the caffe python package, behind a gated
import; the dependency-free path loads an ``.npz`` blob dump with keys
``"{layer}/0"`` (weights) and ``"{layer}/1"`` (bias), the format
``dump_caffemodel_npz`` (run where caffe is installed) produces.

Caffe and MXNet share blob layouts — conv (out, in, kh, kw), fc (out, in)
— so conversion is a rename, not a transpose. The arrays stay on the host
(``cpu()``), and the checkpoint pair the CLI writes (``-symbol.json``,
``-0000.params``) is the one the JAX package writes, so either package's
``FeedForward.load`` reads it:

    python -m mxnet_tpu_torch.tools.caffe_converter.convert_model \
        net.prototxt blobs.npz prefix
"""

from __future__ import annotations

import numpy as np

import mxnet_tpu_torch as mx

__all__ = ["convert_weights", "load_npz_blobs", "load_caffemodel_blobs",
           "dump_caffemodel_npz"]


def load_npz_blobs(path):
    """Load ``{layer: [blob0, blob1, ...]}`` from an npz blob dump."""
    blobs = {}
    with np.load(path) as data:
        for key in data.files:
            layer, idx = key.rsplit("/", 1)
            blobs.setdefault(layer, {})[int(idx)] = data[key]
    return {layer: [d[i] for i in sorted(d)] for layer, d in blobs.items()}


def load_caffemodel_blobs(path):
    """Read blobs from a .caffemodel — requires a caffe installation."""
    import caffe.proto.caffe_pb2 as caffe_pb2  # gated: not in this image

    net = caffe_pb2.NetParameter()
    with open(path, "rb") as f:
        net.ParseFromString(f.read())
    out = {}
    for layer in list(net.layer) + list(net.layers):
        if layer.blobs:
            out[layer.name] = [
                np.array(b.data, np.float32).reshape(
                    tuple(b.shape.dim) if b.shape.dim
                    else (b.num, b.channels, b.height, b.width))
                for b in layer.blobs]
    return out


def dump_caffemodel_npz(caffemodel_path, npz_path):
    """Convert .caffemodel -> .npz blob dump (run under a caffe install)."""
    blobs = load_caffemodel_blobs(caffemodel_path)
    flat = {f"{layer}/{i}": arr
            for layer, arrs in blobs.items() for i, arr in enumerate(arrs)}
    np.savez(npz_path, **flat)


def convert_weights(blobs, symbol=None):
    """Map ``{layer: [W, b]}`` blobs onto ``{arg_name: NDArray}`` on the host.

    When ``symbol`` is given, only layers whose ``{layer}_weight`` exists in
    the symbol's arguments are converted (and a missing layer raises)."""
    args = set(symbol.list_arguments()) if symbol is not None else None
    arg_params = {}
    for layer, arrs in blobs.items():
        wname, bname = f"{layer}_weight", f"{layer}_bias"
        if args is not None and wname not in args:
            continue
        if arrs:
            arg_params[wname] = mx.nd.array(np.asarray(arrs[0], np.float32),
                                           ctx=mx.cpu())
        if len(arrs) > 1:
            arg_params[bname] = mx.nd.array(
                np.asarray(arrs[1], np.float32).ravel(), ctx=mx.cpu())
    if args is not None:
        missing = {a for a in args if a.endswith(("_weight", "_bias"))} \
            - set(arg_params)
        if missing:
            raise ValueError(
                f"no caffe blobs for arguments: {sorted(missing)}")
    return arg_params


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="caffe weights -> params file")
    ap.add_argument("prototxt")
    ap.add_argument("weights", help=".npz blob dump or .caffemodel")
    ap.add_argument("output_prefix")
    args = ap.parse_args(argv)

    from .convert_symbol import proto_to_symbol

    symbol, _ = proto_to_symbol(args.prototxt)
    if args.weights.endswith(".npz"):
        blobs = load_npz_blobs(args.weights)
    else:
        blobs = load_caffemodel_blobs(args.weights)
    arg_params = convert_weights(blobs, symbol)
    symbol.save(f"{args.output_prefix}-symbol.json")
    mx.nd.save(f"{args.output_prefix}-0000.params",
               {f"arg:{k}": v for k, v in arg_params.items()})
    print(f"saved {args.output_prefix}-symbol.json / -0000.params "
          f"({len(arg_params)} arrays)")


if __name__ == "__main__":
    main()
