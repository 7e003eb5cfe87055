from .convert import params_from_numpy
from .transformer import (QuantWeight, TransformerConfig, TransformerLM,
                          linear, quantize_weights)

__all__ = ["QuantWeight", "TransformerConfig", "TransformerLM", "linear",
           "params_from_numpy", "quantize_weights"]
