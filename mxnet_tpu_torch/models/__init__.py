"""Model zoo of the port: the JAX package's Symbol builders, so the same
names and shapes, and its functional transformer LM."""

from .mlp import mlp
from .resnet import resnet, resnet50
from .transformer import TransformerLM, transformer_lm_config

__all__ = ["mlp", "resnet", "resnet50", "TransformerLM",
           "transformer_lm_config"]
