"""Top-k in ``lax.top_k``'s order.

``torch.topk`` promises no order among equal values on CUDA; the
reference's ``lax.top_k`` puts equal values lowest index first. The
samplers' candidates and the MoE router's experts both follow the
reference, so both take :func:`ordered_top_k`.
"""

from __future__ import annotations

import torch


def ordered_top_k(x, k):
    """(values, indices) of the ``k`` largest entries of each row of ``x``,
    in descending order, equal values by ascending index (``lax.top_k``'s
    order, in which -0.0 ranks below +0.0). ``torch.topk`` runs over int64
    keys: the f32 value's bits made to order as a signed int32 in the high
    half, the reversed index in the low half."""
    bits = x.to(torch.float32).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    n = x.shape[-1]
    rev = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    _, indices = torch.topk((ordered.to(torch.int64) << 32) | rev, k,
                            dim=-1)
    return torch.gather(x, -1, indices), indices
