"""Kernels of the port. Each hand-written CUDA kernel (``csrc/*.cu``) has a
wrapper with a launch counter (``wrapper.launches``) and a plain PyTorch
version of the same contract (``<name>_plain``): CPU tensors take the plain
version, CUDA tensors launch the kernel or raise. Wrappers that share a
kernel, each counting its own launches:

* ``decode_attn_int8_tail`` (K1) and ``decode_attn_int8`` (K1', no tail
  window): ``csrc/decode_attn_int8_tail.cu``;
* ``decode_attn_float`` (K6), ``decode_attn_flat_float`` (K8) and
  ``decode_attn_native_dots``: ``csrc/decode_attn_float.cu``;
* ``decode_attn_paged``, ``decode_attn_paged_grid`` and
  ``decode_attn_paged_int8`` (P3, its grid mode and P3i,
  ``csrc/decode_attn_paged.cu``), ``decode_attn_grouped_int8`` without
  ``pv_int8`` (G1, both score modes) and ``decode_attn_fused_int8`` (G2,
  both ``csrc/decode_attn_grouped_int8.cu``, which also serves
  ``decode_attn_int8_partials``, the partials mode), K6 and K8,
  ``verify_attn_grouped`` and ``verify_attn_fused`` (V1,
  ``csrc/verify_attn.cu``), ``decode_attn_grouped_append`` (A1, the
  write fused, ``csrc/decode_attn_append.cu``) and
  ``decode_attn_split_kv`` (K9, separate K and V planes,
  ``csrc/decode_attn_split.cu``): the KV-group kernel of
  ``csrc/decode_attn_kv_group.cuh`` (G1's ``pv_int8`` mode and
  ``decode_attn_native_dots`` in its block modes);
* ``matmul_int4_words`` (Q1) and ``matmul_int4`` (Q2):
  ``csrc/matmul_int4.cu``;
* ``kv_append`` (K5, ``csrc/kv_append.cu``), ``kv_append_int8`` (K7,
  ``csrc/kv_append_int8.cu``), ``kv_append_paged`` and
  ``kv_append_paged_int8`` (P1 and P2, ``csrc/kv_append_paged.cu``) and
  ``tail_flush_int8`` (K3, ``csrc/tail_flush_int8.cu``): the
  eight-lanes-a-row kernel of ``csrc/kv_append.cuh``, with a float (K5,
  P1) or an int8 (K7, P2, K3) row policy, over the new f32 rows (K3: the
  bf16 tail window's first t rows), through a position, the page table
  or the flush's window offset.

The others have a source each: ``flash_attention`` (F1),
``head_argmax_int8`` (K2), ``matmul_int8_wo``
(K4), ``matmul_int4_words_int8`` (Q1', ``csrc/matmul_int4_int8dot.cu``)
and ``matmul_int8_tiled`` (M1, ``csrc/matmul_int8.cu``). The verify wrappers
also count per mode (float or int8 cache) in ``mode_launches``, and
``decode_attn_grouped_int8`` per mode (exact q or int8 scores, each with or
without ``pv_int8``)."""

from .attention import (decode_attn_flat_float, decode_attn_float,
                        decode_attn_fused_int8, decode_attn_grouped_append,
                        decode_attn_grouped_int8, decode_attn_int8,
                        decode_attn_int8_partials, decode_attn_int8_tail,
                        decode_attn_native_dots, decode_attn_paged,
                        decode_attn_paged_grid, decode_attn_paged_int8,
                        decode_attn_split_kv, flash_attention,
                        verify_attn_fused, verify_attn_grouped)
from .cache import (kv_append, kv_append_int8, kv_append_paged,
                    kv_append_paged_int8, tail_flush_int8)
from .gemm import (head_argmax_int8, matmul_int4, matmul_int4_words,
                   matmul_int4_words_int8, matmul_int8_tiled, matmul_int8_wo)

KERNELS = (decode_attn_int8_tail, head_argmax_int8, tail_flush_int8,
           matmul_int8_wo, kv_append, decode_attn_float, kv_append_int8,
           decode_attn_int8, kv_append_paged, kv_append_paged_int8,
           decode_attn_paged, decode_attn_paged_int8, decode_attn_paged_grid,
           matmul_int4_words, matmul_int4_words_int8, matmul_int4,
           verify_attn_grouped, verify_attn_fused, flash_attention,
           decode_attn_grouped_int8, decode_attn_fused_int8,
           decode_attn_grouped_append, decode_attn_flat_float,
           decode_attn_int8_partials, decode_attn_split_kv,
           decode_attn_native_dots, matmul_int8_tiled)


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


__all__ = ["KERNELS", "decode_attn_flat_float", "decode_attn_float",
           "decode_attn_fused_int8", "decode_attn_grouped_append",
           "decode_attn_grouped_int8", "decode_attn_int8",
           "decode_attn_int8_partials", "decode_attn_int8_tail",
           "decode_attn_native_dots", "decode_attn_paged",
           "decode_attn_paged_grid", "decode_attn_paged_int8",
           "decode_attn_split_kv", "flash_attention", "head_argmax_int8",
           "kv_append", "kv_append_int8", "kv_append_paged",
           "kv_append_paged_int8", "launch_counts", "matmul_int4",
           "matmul_int4_words", "matmul_int4_words_int8",
           "matmul_int8_tiled", "matmul_int8_wo", "reset_launch_counts",
           "tail_flush_int8", "verify_attn_fused", "verify_attn_grouped"]
