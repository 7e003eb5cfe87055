"""Kernels of the port. Each hand-written CUDA kernel (``csrc/*.cu``) has a
wrapper with a launch counter (``wrapper.launches``) and a plain PyTorch
version of the same contract (``<name>_plain``): CPU tensors take the plain
version, CUDA tensors launch the kernel or raise. ``decode_attn_int8``
launches the kernel of ``decode_attn_int8_tail`` without a tail window, and
``decode_attn_paged_grid`` and ``decode_attn_paged_int8`` the kernel of
``decode_attn_paged`` in other modes, and ``matmul_int4_words_int8`` and
``matmul_int4`` the kernel of ``matmul_int4_words`` in other modes, and
``verify_attn_fused`` the kernel of ``verify_attn_grouped``, and
``decode_attn_fused_int8`` the kernel of ``decode_attn_grouped_int8``; each
counts its own launches. The verify wrappers also count per mode (float or
int8 cache) in ``mode_launches``, and ``decode_attn_grouped_int8`` per
score mode (exact q or int8 scores)."""

from .attention import (decode_attn_float, decode_attn_fused_int8,
                        decode_attn_grouped_append, decode_attn_grouped_int8,
                        decode_attn_int8, decode_attn_int8_tail,
                        decode_attn_paged, decode_attn_paged_grid,
                        decode_attn_paged_int8, flash_attention,
                        verify_attn_fused, verify_attn_grouped)
from .cache import (kv_append, kv_append_int8, kv_append_paged,
                    kv_append_paged_int8, tail_flush_int8)
from .gemm import (head_argmax_int8, matmul_int4, matmul_int4_words,
                   matmul_int4_words_int8, matmul_int8_wo)

KERNELS = (decode_attn_int8_tail, head_argmax_int8, tail_flush_int8,
           matmul_int8_wo, kv_append, decode_attn_float, kv_append_int8,
           decode_attn_int8, kv_append_paged, kv_append_paged_int8,
           decode_attn_paged, decode_attn_paged_int8, decode_attn_paged_grid,
           matmul_int4_words, matmul_int4_words_int8, matmul_int4,
           verify_attn_grouped, verify_attn_fused, flash_attention,
           decode_attn_grouped_int8, decode_attn_fused_int8,
           decode_attn_grouped_append)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        for mode in getattr(k, "mode_launches", ()):
            k.mode_launches[mode] = 0


def launch_counts():
    """{wrapper name: launches}, and {"<name>.<mode>": launches} for the
    wrappers that also count per mode."""
    out = {}
    for k in KERNELS:
        out[k.__name__] = k.launches
        for mode, n in getattr(k, "mode_launches", {}).items():
            out[f"{k.__name__}.{mode}"] = n
    return out


__all__ = ["KERNELS", "decode_attn_float", "decode_attn_fused_int8",
           "decode_attn_grouped_append", "decode_attn_grouped_int8",
           "decode_attn_int8", "decode_attn_int8_tail", "decode_attn_paged",
           "decode_attn_paged_grid", "decode_attn_paged_int8",
           "flash_attention", "head_argmax_int8", "kv_append",
           "kv_append_int8",
           "launch_counts",
           "kv_append_paged", "kv_append_paged_int8", "matmul_int4",
           "matmul_int4_words", "matmul_int4_words_int8", "matmul_int8_wo",
           "reset_launch_counts", "tail_flush_int8", "verify_attn_fused",
           "verify_attn_grouped"]
