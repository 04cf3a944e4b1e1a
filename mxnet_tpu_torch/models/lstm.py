"""Unrolled LSTM language model as a Symbol graph.

Counterpart of ``mxnet_tpu/models/lstm.py`` (reference:
example/rnn/lstm.py:43-99): ``seq_len`` x ``num_layers`` cells over shared
weight variables, per-step ``t{i}_data`` / ``t{i}_label`` inputs, grouped
per-step SoftmaxOutputs and the final states under BlockGrad. Built from
the port's ``FullyConnected``, ``SliceChannel``, ``Activation``,
``Embedding``, ``Dropout``, ``BlockGrad`` and ``Group``; the same names and
shapes as the JAX package's, so parameters cross as they are. The time
loop of ``models.lstm_scan.LSTMLM`` is the faster form of the same cell.
"""

from __future__ import annotations

from collections import namedtuple

from .. import symbol as sym

__all__ = ["lstm_unroll", "LSTMState", "LSTMParam"]

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def _lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx):
    """One LSTM cell over shared weight symbols; gate order in, transform,
    forget, out."""
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden * 4,
                             name=f"t{seqidx}_l{layeridx}_i2h")
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name=f"t{seqidx}_l{layeridx}_h2h")
    gates = i2h + h2h
    slice_gates = sym.SliceChannel(gates, num_outputs=4,
                                   name=f"t{seqidx}_l{layeridx}_slice")
    in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
    in_transform = sym.Activation(slice_gates[1], act_type="tanh")
    forget_gate = sym.Activation(slice_gates[2], act_type="sigmoid")
    out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_layers, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0):
    """The fully unrolled training graph. Inputs: ``t{i}_data`` (token
    ids), ``t{i}_label`` and the initial states ``l{j}_init_c`` /
    ``l{j}_init_h``; outputs: the per-step SoftmaxOutputs, then the final
    ``c`` and ``h`` of each layer under BlockGrad."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_layers):
        param_cells.append(LSTMParam(
            i2h_weight=sym.Variable(f"l{i}_i2h_weight"),
            i2h_bias=sym.Variable(f"l{i}_i2h_bias"),
            h2h_weight=sym.Variable(f"l{i}_h2h_weight"),
            h2h_bias=sym.Variable(f"l{i}_h2h_bias"),
        ))
        last_states.append(LSTMState(
            c=sym.Variable(f"l{i}_init_c"), h=sym.Variable(f"l{i}_init_h")))

    out_prob = []
    for seqidx in range(seq_len):
        data = sym.Variable(f"t{seqidx}_data")
        hidden = sym.Embedding(data=data, weight=embed_weight,
                               input_dim=input_size, output_dim=num_embed,
                               name=f"t{seqidx}_embed")
        for i in range(num_layers):
            next_state = _lstm_cell(num_hidden, indata=hidden,
                                    prev_state=last_states[i],
                                    param=param_cells[i],
                                    seqidx=seqidx, layeridx=i)
            hidden = next_state.h
            last_states[i] = next_state
            if dropout > 0.0:
                hidden = sym.Dropout(data=hidden, p=dropout)
        fc = sym.FullyConnected(data=hidden, weight=cls_weight, bias=cls_bias,
                                num_hidden=num_label, name=f"t{seqidx}_cls")
        label = sym.Variable(f"t{seqidx}_label")
        out_prob.append(sym.SoftmaxOutput(data=fc, label=label,
                                          name=f"t{seqidx}_sm"))

    for i in range(num_layers):
        state = last_states[i]
        last_states[i] = LSTMState(
            c=sym.BlockGrad(state.c, name=f"l{i}_last_c"),
            h=sym.BlockGrad(state.h, name=f"l{i}_last_h"))
    return sym.Group(out_prob + [s.c for s in last_states]
                     + [s.h for s in last_states])
