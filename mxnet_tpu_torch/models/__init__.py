"""Model zoo of the port: the JAX package's Symbol builders, so the same
names and shapes, its functional transformer LM and its MoE pipeline LM."""

from .mlp import mlp
from .moe_transformer import MoEPipelineLM, moe_pipeline_config
from .resnet import resnet, resnet50
from .transformer import TransformerLM, transformer_lm_config

__all__ = ["mlp", "resnet", "resnet50", "TransformerLM",
           "transformer_lm_config", "MoEPipelineLM", "moe_pipeline_config"]
