"""How far int4-weight logits move when the activations move by one f32
rounding, at TinyLlama's and Mistral-7B's widths, on the CPU.

The card and the CPU sum a linear's f32 products in other orders, so an
activation may differ by an f32 rounding between them; the int4 word
formula rounds activations to bf16, and such a difference can flip that
rounding (``chip_smoke.py``, ``LLAMA_PATH_LOGIT_TOL``). This script runs
one layer of each model (random int4 words weights, 4 prompts of 128
tokens, an int8 cache, then 3 greedy decode steps) twice on the CPU: as is,
and with every quantized linear's input multiplied by 1 + r * 2^-23 for r
drawn from {-1, 0, 1}. It prints the largest logit difference at each step,
the scale of the gap between the card's logits and the CPU's that the
card-against-CPU phases of ``chip_smoke.py`` must allow.

    python -m rten_tpu_torch.tools.int4_flip_sensitivity
"""

from __future__ import annotations

import time

import torch

from ..models import QuantWeight, TransformerConfig, TransformerLM
from ..models import transformer as tr


def logits_per_step(model, params, tokens, eps, steps=3):
    """Prefill logits, then ``steps`` greedy decode steps' logits, with
    every quantized linear's input perturbed by ``eps`` (0: none)."""
    g = torch.Generator().manual_seed(1)
    linear = tr.linear

    def perturbed(x, w, bias=None):
        if eps and isinstance(w, QuantWeight):
            r = torch.randint(-1, 2, x.shape, generator=g).to(x.dtype)
            x = x * (1 + eps * r)
        return linear(x, w, bias)

    tr.linear = perturbed
    try:
        b, s = tokens.shape
        cache = model.new_cache(b, 2 * s, quantized=True, device="cpu")
        logits, cache = model.prefill_last(params, tokens, cache,
                                           torch.full((b,), s - 1))
        out = [logits]
        for _ in range(steps):
            logits, cache = model.decode_step(params, logits.argmax(-1),
                                              cache)
            out.append(logits)
        return out
    finally:
        tr.linear = linear


def main():
    for name, cfg in (
            ("TinyLlama-1.1B width, 1 layer",
             TransformerConfig.tiny_llama(n_layers=1)),
            ("Mistral-7B width, 1 layer",
             TransformerConfig.mixtral(n_experts=0, n_layers=1))):
        t0 = time.perf_counter()
        model = TransformerLM(cfg)
        params = model.init_int4_params(0, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (4, 128),
                               generator=torch.Generator().manual_seed(2))
        base = logits_per_step(model, params, tokens, 0.0)
        moved = logits_per_step(model, params, tokens, 2.0 ** -23)
        gaps = [float((a - b).abs().max()) for a, b in zip(base, moved)]
        print(f"{name}: largest logit difference per step (prefill, then "
              f"decode) after one-rounding activation changes: "
              + ", ".join(f"{x:.4f}" for x in gaps)
              + f"; max |logit| {float(base[0].abs().max()):.2f} "
              f"({time.perf_counter() - t0:.0f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main()
