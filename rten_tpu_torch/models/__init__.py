from .bert import Bert, BertConfig
from .checkpoint import load_params, save_params
from .convert import params_from_numpy, resnet_params_from_numpy
from .encoder_decoder import (EncoderDecoderConfig, EncoderDecoderLM,
                              log_mel_spectrogram)
from .resnet import ResNet, ResNetConfig
from .sam import SAM, SAMConfig, fourier_point_embedding
from .segmentation import SegmentationConfig, Segmenter
from .transformer import (QuantWeight, TransformerConfig, TransformerLM,
                          linear, quantize_weights, stack_layer_params)
from .tts import TextToSpeech, TTSConfig
from .vit import DepthConfig, DepthEstimator, ViT, ViTConfig

__all__ = ["Bert", "BertConfig", "DepthConfig", "DepthEstimator",
           "EncoderDecoderConfig", "EncoderDecoderLM", "QuantWeight",
           "ResNet", "ResNetConfig", "SAM", "SAMConfig",
           "SegmentationConfig", "Segmenter", "TTSConfig", "TextToSpeech",
           "TransformerConfig", "TransformerLM", "ViT", "ViTConfig",
           "fourier_point_embedding", "linear", "load_params",
           "log_mel_spectrogram", "params_from_numpy", "quantize_weights",
           "resnet_params_from_numpy", "save_params", "stack_layer_params"]
