"""RTen container format: header, FlatBuffers schema, reader/writer."""

from .container import ModelFile, TensorDataBuilder, load_bytes, load_file, save_bytes, save_file
from .header import Header, HeaderError
from .model_builder import GraphBuilder, ModelBuilder
from . import schema

__all__ = [
    "ModelFile", "TensorDataBuilder", "load_bytes", "load_file",
    "save_bytes", "save_file", "Header", "HeaderError",
    "GraphBuilder", "ModelBuilder", "schema",
]
