"""Model zoo of the port: the JAX package's Symbol builders, so the same
names and shapes (the unrolled LSTM LM among them), its functional
transformer LM, its MoE pipeline LM and its LSTM LM with the time loop in
torch."""

from .alexnet import alexnet
from .inception import inception_bn, inception_bn_cifar
from .lenet import lenet
from .lstm import lstm_unroll
from .lstm_scan import LSTMLM
from .mlp import mlp
from .moe_transformer import MoEPipelineLM, moe_pipeline_config
from .resnet import resnet, resnet50
from .transformer import TransformerLM, transformer_lm_config

__all__ = ["mlp", "lenet", "alexnet", "inception_bn_cifar", "inception_bn",
           "resnet", "resnet50", "lstm_unroll", "LSTMLM", "TransformerLM",
           "transformer_lm_config", "MoEPipelineLM", "moe_pipeline_config"]
