"""Framework walkthrough, the port's counterpart of
``examples/python_howto/basics.py`` (rewrite of the reference
example/python-howto: symbol composition, shape inference, binding, the
imperative NDArray layer, and saving/loading — each step printed).

    python -m mxnet_tpu_torch.examples.python_howto.basics [--cpu]

The arrays and the executor live on the card unless ``--cpu`` is given;
the port's executor holds torch tensors, read back with ``.cpu()``.
"""

import numpy as np
import torch

from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import symbol as sym

from .. import cpu_parser, example_context


def walkthrough(ctx):
    """The five steps; returns what each printed, as numpy."""
    # --- 1. imperative NDArray --------------------------------------------
    a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = nd.ones((2, 3))
    c = a * 2 + b
    print("NDArray math:\n", c.asnumpy())

    # --- 2. symbolic composition ------------------------------------------
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, name="fc1", num_hidden=8)
    net = sym.Activation(data=net, name="relu1", act_type="relu")
    net = sym.FullyConnected(data=net, name="fc2", num_hidden=3)
    out = sym.SoftmaxOutput(data=net, name="softmax")
    print("arguments:", out.list_arguments())
    print("outputs:", out.list_outputs())

    # --- 3. shape inference -------------------------------------------------
    arg_shapes, out_shapes, _ = out.infer_shape(data=(4, 10))
    print("inferred arg shapes:", dict(zip(out.list_arguments(), arg_shapes)))
    print("inferred out shapes:", out_shapes)

    # --- 4. bind + forward + backward --------------------------------------
    exe = out.simple_bind(ctx=ctx, data=(4, 10), softmax_label=(4,))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, arr in exe.arg_dict.items():
            if name not in ("data", "softmax_label"):
                arr.copy_(nd.array(rng.randn(*arr.shape).astype(np.float32)
                                   * 0.1).data)
    x = rng.randn(4, 10).astype(np.float32)
    y = np.array([0, 1, 2, 0], np.float32)
    probs = exe.forward(is_train=True, data=x, softmax_label=y)[0]
    probs = probs.cpu().numpy()
    print("softmax row sums:", probs.sum(axis=1))
    exe.backward()
    grad = exe.grad_dict["fc1_weight"].cpu().numpy()
    print("dL/d(fc1_weight) shape:", tuple(grad.shape))

    # --- 5. graph introspection + save/load --------------------------------
    print(out.debug_str().splitlines()[0])
    js = out.tojson()
    out2 = sym.load_json(js)
    assert out2.list_arguments() == out.list_arguments()
    print("symbol JSON roundtrip ok:", len(js), "bytes")
    return {"c": c.asnumpy(), "probs": probs, "fc1_weight_grad": grad,
            "arg_shapes": arg_shapes, "out_shapes": out_shapes,
            "json": js, "card": str(c.data.device)}


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        return walkthrough(ctx)


if __name__ == "__main__":
    main()
