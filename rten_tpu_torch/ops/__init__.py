from .registry import OPS, OpError, OpSpec, ensure_registered, get_op, register

__all__ = ["OPS", "OpError", "OpSpec", "ensure_registered", "get_op",
           "register"]
