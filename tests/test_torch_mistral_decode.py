"""Teacher-forced decode logits of a small d = 128 model of Mistral-7B's
family (``TransformerConfig.mixtral(n_experts=0)`` at width 256) against
the JAX package on the CPU, on each decode kernel that the reference's
dispatch takes for it: K1', G1 in both score modes, G2, and A1 (the fused
append). The shared setup is in tests/test_torch_mistral.py."""

import pytest

from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import kv_cache
from rten_tpu_torch.models import TransformerConfig, TransformerLM
from test_torch_mistral import (F32_LOGIT_TOL, FLAT_LOGIT_TOL, SMALL,
                                _spy, _teacher_forced, small)  # noqa: F401


# name: (config overrides, batch, capacity, new_cache kwargs, the wrapper
# each decode step reaches, with its int8_scores, and the tolerance)
DECODE = {
    "flat": (dict(), 4, 128, dict(quantized=True),
             ("decode_attn_int8", False), FLAT_LOGIT_TOL),
    "grouped": (dict(decode_attn="grouped"), 4, 2048, dict(quantized=True),
                ("decode_attn_grouped_int8", False), F32_LOGIT_TOL),
    "grouped_scores": (dict(decode_attn="grouped"), 4, 128,
                       dict(quantized=True),
                       ("decode_attn_grouped_int8", True), F32_LOGIT_TOL),
    "fused": (dict(), 3, 128, dict(quantized=True),
              ("decode_attn_fused_int8", False), F32_LOGIT_TOL),
    "fused_append": (dict(fused_append=True), 4, 128,
                     dict(cache_dtype="bfloat16"),
                     ("decode_attn_grouped_append", False), F32_LOGIT_TOL),
}


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_logits_match_reference(small, monkeypatch, name):
    """Teacher-forced decode of the small d = 128 model on each kernel the
    reference's dispatch takes for it: K1' (auto, batch 4), G1 with exact
    q (decode_attn "grouped" at capacity 2048) and with int8 scores
    (capacity 128), G2 (batch 3), and A1 (fused_append on a bf16 cache,
    where the append kernels do not run)."""
    jm, jp, pp = small
    over, b, cap, kw, want, tol = DECODE[name]
    jm2 = jtr.TransformerLM(jtr.TransformerConfig.mixtral(**SMALL, **over))
    pm = TransformerLM(TransformerConfig.mixtral(**SMALL, **over))
    calls = _spy(monkeypatch, ("decode_attn_int8", "decode_attn_grouped_int8",
                               "decode_attn_fused_int8",
                               "decode_attn_grouped_append",
                               "decode_attn_float"))
    appends = []
    monkeypatch.setattr(kv_cache, "kv_append",
                        lambda *a: appends.append(a))
    worst = _teacher_forced(jm2, pm, jp, pp, b, cap, kw)
    print(f"{name}: worst teacher-forced logit difference {worst:.3e}")
    assert set(calls) == {want}
    if name == "fused_append":
        assert len(calls) == 3 * SMALL["n_layers"] and not appends
    assert worst < tol, worst
