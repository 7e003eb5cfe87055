"""Kernels of the port. Each hand-written CUDA kernel (``csrc/*.cu``) has a
wrapper with a launch counter (``wrapper.launches``) and a plain PyTorch
version of the same contract (``<name>_plain``): CPU tensors take the plain
version, CUDA tensors launch the kernel or raise."""

from .attention import decode_attn_int8_tail
from .cache import tail_flush_int8
from .gemm import head_argmax_int8, matmul_int8_wo

KERNELS = (decode_attn_int8_tail, head_argmax_int8, tail_flush_int8,
           matmul_int8_wo)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "decode_attn_int8_tail", "head_argmax_int8",
           "matmul_int8_wo", "reset_launch_counts", "tail_flush_int8"]
