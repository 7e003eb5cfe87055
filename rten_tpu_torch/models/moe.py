"""Mixture-of-Experts feed-forward block (port of
``rten_tpu/models/moe.py``; Mixtral / Switch-Transformer class).

* **Routing** (:func:`route_topk`): softmax over all experts in f32, the
  top k, the selected weights renormalized (HF ``MixtralSparseMoeBlock``'s
  convention).
* **Dense path** (:func:`_moe_dense`): every expert's FFN over every token,
  combined by the [T, E] routing matrix (zero where an expert is not
  selected). Decode-size token counts and int8 expert stacks take it.
* **Ragged path** (:func:`_moe_ragged`): the T·k (token, expert)
  assignments sorted by expert (stable), each projection one grouped
  product over the sorted rows, the weighted rows scatter-added back in
  f32. Dropless: no capacity factor, no token is dropped.

Expert weights are stacks ``[E, d_in, d_out]``: float, or int8 per expert
and output channel (:class:`~rten_tpu_torch.models.transformer.QuantWeight`
with ``data`` [E, K, N] and ``scales`` [E, N]). The expert products are
library products, as the reference's XLA einsums and ``lax.ragged_dot``
are: each operand is rounded to the compute dtype as the reference casts
it, then widened to f32 (exact) so every product has the reference's f32
result (``preferred_element_type=float32``); int8 scales multiply the
product afterwards.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..utils.topk import ordered_top_k

# Calls of each path since the last reset: "dense" or "ragged".
impl_counts = Counter()


def route_topk(router_logits, k):
    """Mixtral routing: softmax over ALL experts (f32), top ``k``,
    renormalized. Returns (weights [T, k] f32, expert idx [T, k] int32).
    Equal probabilities go to the lower expert index first, as
    ``lax.top_k`` orders them (:func:`ordered_top_k`, which the samplers
    share)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    weights, idx = ordered_top_k(probs, k)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx.to(torch.int32)


def combine_matrix(idx, weights, n_experts):
    """Sparse [T, k] routing → dense combine matrix [T, E] (zero where an
    expert is not selected)."""
    onehot = torch.nn.functional.one_hot(idx.to(torch.int64),
                                         n_experts).to(weights.dtype)
    return torch.einsum("tke,tk->te", onehot, weights)


def _as_float(w, dtype):
    """Expert stack → (f32 tensor [E, K, N] holding values of ``dtype``,
    int8 scales [E, N] or None): float stacks rounded to the compute dtype
    as the reference casts them; int8 data exactly (int8 fits bf16)."""
    from .transformer import QuantWeight
    if isinstance(w, QuantWeight):
        if w.kind != "int8":
            raise NotImplementedError("MoE expert stacks support int8 only")
        return w.data[..., :w.n].to(torch.float32), w.scales[..., :w.n]
    return w.to(dtype).to(torch.float32), None


def _moe_dense(x2, cw, layer, act, compute_dtype):
    """All-experts path: h[e] = FFN_e(x) for every expert, combined with
    the routing matrix. x2 [T, d], cw [T, E] → [T, d] f32."""
    wu, su = _as_float(layer["w_up"], compute_dtype)
    wd, sd = _as_float(layer["w_down"], compute_dtype)
    xc = x2.to(compute_dtype).to(torch.float32)
    up = torch.matmul(xc[None], wu)                          # [E, T, F]
    if su is not None:
        up = up * su[:, None, :]
    if act == "swiglu":
        wg, sg = _as_float(layer["w_gate"], compute_dtype)
        gate = torch.matmul(xc[None], wg)
        if sg is not None:
            gate = gate * sg[:, None, :]
        h = torch.nn.functional.silu(gate) * up
    else:
        if "b_up" in layer:
            up = up + layer["b_up"][:, None, :]
        h = torch.nn.functional.gelu(up, approximate="none")
    out = torch.matmul(h.to(compute_dtype).to(torch.float32), wd)
    if sd is not None:
        out = out * sd[:, None, :]
    if "b_down" in layer:
        out = out + layer["b_down"][:, None, :]
    return torch.einsum("etd,te->td", out, cw.to(torch.float32))


def _moe_ragged(x2, weights, idx, layer, act, n_experts, compute_dtype):
    """Dropless grouped path: the T·k assignments sorted by expert (stable),
    each projection one product per expert over its contiguous run of
    sorted rows, the weighted rows scatter-added back in f32.
    x2 [T, d] → [T, d] f32."""
    t, d = x2.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1).to(torch.int64)                 # [A], A = T*k
    order = torch.sort(flat_e, stable=True).indices
    tok = order // k                                         # token per row
    xg = x2[tok].to(compute_dtype).to(torch.float32)
    sizes = torch.bincount(flat_e, minlength=n_experts).tolist()
    sorted_e = flat_e[order]

    def rdot(lhs, w):
        wf, scales = _as_float(w, compute_dtype)
        rows = lhs.to(compute_dtype).to(torch.float32).split(sizes)
        out = torch.cat([part @ wf[e] for e, part in enumerate(rows)])
        if scales is not None:
            out = out * scales[sorted_e]
        return out

    up = rdot(xg, layer["w_up"])
    if act == "swiglu":
        h = torch.nn.functional.silu(rdot(xg, layer["w_gate"])) * up
    else:
        if "b_up" in layer:
            up = up + layer["b_up"][sorted_e]
        h = torch.nn.functional.gelu(up, approximate="none")
    out = rdot(h, layer["w_down"])
    if "b_down" in layer:
        out = out + layer["b_down"][sorted_e]
    wsorted = weights.reshape(-1)[order].to(torch.float32)
    y = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
    return y.index_add_(0, tok, out * wsorted[:, None])


def moe_mlp(x, layer_params, cfg):
    """MoE feed-forward. x [..., d] → the same shape and dtype.

    Path (``cfg.moe_impl``): "dense", "ragged" or "auto": the ragged path
    for more than 64 tokens, the dense one at decode-size token counts;
    int8 expert stacks always take the dense path (reference moe.py:
    140-155). Each call counts its path in :data:`impl_counts`."""
    from .transformer import QuantWeight, compute_dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    t = x2.shape[0]
    logits = torch.matmul(x2.to(torch.float32),
                          layer_params["router"].to(torch.float32))
    weights, idx = route_topk(logits, cfg.experts_per_token)
    quantized = isinstance(layer_params["w_up"], QuantWeight)
    impl = cfg.moe_impl
    if impl == "auto":
        impl = "dense" if (t <= 64 or quantized) else "ragged"
    dtype = compute_dtype(cfg)
    if impl == "ragged" and not quantized:
        impl_counts["ragged"] += 1
        y = _moe_ragged(x2, weights, idx, layer_params, cfg.act,
                        cfg.n_experts, dtype)
    else:
        impl_counts["dense"] += 1
        cw = combine_matrix(idx, weights, cfg.n_experts)
        y = _moe_dense(x2, cw, layer_params, cfg.act, dtype)
    return y.reshape(*lead, -1).to(x.dtype)
