from .convert import params_from_numpy, resnet_params_from_numpy
from .resnet import ResNet, ResNetConfig
from .transformer import (QuantWeight, TransformerConfig, TransformerLM,
                          linear, quantize_weights)

__all__ = ["QuantWeight", "ResNet", "ResNetConfig", "TransformerConfig",
           "TransformerLM", "linear", "params_from_numpy",
           "quantize_weights", "resnet_params_from_numpy"]
