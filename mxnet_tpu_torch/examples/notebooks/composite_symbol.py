"""Composing symbols into components (notebook-style walkthrough), the
port's counterpart of ``examples/notebooks/composite_symbol.py``.

Reference counterpart: example/notebooks/composite_symbol.ipynb — building
an Inception network from small reusable symbol factories and visualizing
the pieces. Run it top to bottom:

    python -m mxnet_tpu_torch.examples.notebooks.composite_symbol [--cpu]

Each section of :func:`main` mirrors a notebook cell; print output stands
in for cell output. The graphviz source goes to ``composite_symbol.dot`` in
the temporary directory (``TMPDIR``). Nothing here runs on a device; the
script takes ``--cpu`` as every example does, and without it asks for the
card.
"""

import os
import tempfile

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context

# For a complex network such as Inception, composing single symbols by hand
# is painful. Small "component factories" make it mechanical: each factory
# takes the previous symbol and returns a bigger composite.


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                name=None, suffix=''):
    conv = mx.symbol.Convolution(data=data, num_filter=num_filter,
                                 kernel=kernel, stride=stride, pad=pad,
                                 name='conv_%s%s' % (name, suffix))
    bn = mx.symbol.BatchNorm(data=conv, name='bn_%s%s' % (name, suffix))
    act = mx.symbol.Activation(data=bn, act_type='relu',
                               name='relu_%s%s' % (name, suffix))
    return act


# Inception building blocks: factory A (1x1 / 3x3 / double-3x3 / pool
# towers concatenated on channels) and factory B (stride-2 downsampling).

def InceptionFactoryA(data, n1x1, n3x3r, n3x3, nd3x3r, nd3x3, proj, name):
    c1x1 = ConvFactory(data, n1x1, (1, 1), name='%s_1x1' % name)
    c3x3r = ConvFactory(data, n3x3r, (1, 1), name='%s_3x3' % name,
                        suffix='_reduce')
    c3x3 = ConvFactory(c3x3r, n3x3, (3, 3), pad=(1, 1), name='%s_3x3' % name)
    cd3r = ConvFactory(data, nd3x3r, (1, 1), name='%s_d3x3' % name,
                       suffix='_reduce')
    cd3a = ConvFactory(cd3r, nd3x3, (3, 3), pad=(1, 1),
                       name='%s_d3x3_0' % name)
    cd3b = ConvFactory(cd3a, nd3x3, (3, 3), pad=(1, 1),
                       name='%s_d3x3_1' % name)
    pool = mx.symbol.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                             pad=(1, 1), pool_type='avg',
                             name='avg_pool_%s_pool' % name)
    cproj = ConvFactory(pool, proj, (1, 1), name='%s_proj' % name)
    return mx.symbol.Concat(c1x1, c3x3, cd3b, cproj,
                            name='ch_concat_%s_chconcat' % name)


def InceptionFactoryB(data, n3x3r, n3x3, nd3x3r, nd3x3, name):
    c3x3r = ConvFactory(data, n3x3r, (1, 1), name='%s_3x3' % name,
                        suffix='_reduce')
    c3x3 = ConvFactory(c3x3r, n3x3, (3, 3), pad=(1, 1), stride=(2, 2),
                       name='%s_3x3' % name)
    cd3r = ConvFactory(data, nd3x3r, (1, 1), name='%s_d3x3' % name,
                       suffix='_reduce')
    cd3a = ConvFactory(cd3r, nd3x3, (3, 3), pad=(1, 1),
                       name='%s_d3x3_0' % name)
    cd3b = ConvFactory(cd3a, nd3x3, (3, 3), pad=(1, 1), stride=(2, 2),
                       name='%s_d3x3_1' % name)
    # NOTE: Pooling uses floor output-shape rounding, as the JAX package's;
    # the reference's v0.5 pooling rounded up. pad=(1,1) keeps the tower
    # shapes aligned under floor rounding.
    pool = mx.symbol.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                             pad=(1, 1), pool_type='max',
                             name='max_pool_%s_pool' % name)
    return mx.symbol.Concat(c3x3, cd3b, pool,
                            name='ch_concat_%s_chconcat' % name)


def component():
    """A factory is itself composable: one fed a free Variable."""
    prev = mx.symbol.Variable(name="previous_output")
    return ConvFactory(data=prev, num_filter=64, kernel=(7, 7),
                       stride=(2, 2))


def build_net():
    """The full network, a linear chain of factory calls."""
    data = mx.symbol.Variable(name="data")
    # stage 1
    conv1 = ConvFactory(data=data, num_filter=64, kernel=(7, 7),
                        stride=(2, 2), pad=(3, 3), name='conv1')
    pool1 = mx.symbol.Pooling(data=conv1, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type='max', name='pool1')
    # stage 2
    conv2red = ConvFactory(data=pool1, num_filter=64, kernel=(1, 1),
                           name='conv2red')
    conv2 = ConvFactory(data=conv2red, num_filter=192, kernel=(3, 3),
                        pad=(1, 1), name='conv2')
    pool2 = mx.symbol.Pooling(data=conv2, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type='max', name='pool2')
    # stage 3
    in3a = InceptionFactoryA(pool2, 64, 64, 64, 64, 96, 32, '3a')
    in3b = InceptionFactoryA(in3a, 64, 64, 96, 64, 96, 64, '3b')
    in3c = InceptionFactoryB(in3b, 128, 160, 64, 96, '3c')
    # head
    avg = mx.symbol.Pooling(data=in3c, kernel=(14, 14), stride=(1, 1),
                            pool_type='avg', name='global_pool')
    flatten = mx.symbol.Flatten(data=avg, name='flatten')
    fc1 = mx.symbol.FullyConnected(data=flatten, num_hidden=1000, name='fc1')
    return mx.symbol.SoftmaxOutput(data=fc1, name='softmax')


def dot_path():
    return os.path.join(tempfile.gettempdir(), "composite_symbol.dot")


def main(argv=None):
    """Runs the walkthrough; returns ``{"softmax": the network, "dot": the
    graphviz source, "json": its JSON, "out_shape": ...}``."""
    args = cpu_parser(__doc__).parse_args(argv)
    with example_context(args.cpu):
        conv_comp = component()
        print("one ConvFactory component:")
        print(" arguments:", conv_comp.list_arguments())

        softmax = build_net()
        print("\nfull composite network:")
        print(" #arguments:", len(softmax.list_arguments()))

        # Shape inference flows through the whole composite:
        _, out_shapes, _ = softmax.infer_shape(data=(2, 3, 224, 224))
        print(" output shape for 2x3x224x224 input:", out_shapes[0])

        # Graphviz rendering (writes a .dot you can render with `dot -Tpng`):
        path = dot_path()
        dot = mx.viz.plot_network(softmax, shape={"data": (2, 3, 224, 224)},
                                  save_path=path)
        print(" graphviz dot written to", path)

        # A symbol round-trips through JSON (checkpoint format parity):
        js = softmax.tojson()
        back = mx.symbol.load_json(js)
        assert back.list_arguments() == softmax.list_arguments()
        print(" JSON round-trip OK (%d bytes)" % len(js))
    return {"softmax": softmax, "dot": dot, "json": js,
            "out_shape": out_shapes[0]}


if __name__ == "__main__":
    main()
