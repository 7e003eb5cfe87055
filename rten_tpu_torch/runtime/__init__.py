from .executor import GraphExecutor, RunOptions
from .model import Model, ModelMetadata, ModelOptions, RunError
from .timing import RunTiming

__all__ = ["GraphExecutor", "RunOptions", "Model", "ModelMetadata",
           "ModelOptions", "RunError", "RunTiming"]
