"""BERT-family encoder (port of ``rten_tpu/models/bert.py``).

Token, position and segment embeddings, post-layer-norm blocks (the
original BERT ordering), the [CLS] pooler, the QA span head and a
mean-pooled embedding. Dynamic int8 is the reference's
``quantize_weights(params, "int8")`` tree through the port's
:func:`~rten_tpu_torch.models.transformer.linear`: per-tensor activation
quantization and an int8 x int8 product at M > 64 rows, a bf16 dot on the
int8 weight at M <= 64. Attention is ``attn_reference`` with right-padded
masks reduced to per-sequence lengths, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import attn_reference
from ..ops.common import full_f32
from .convert import params_from_numpy
from .transformer import linear


@dataclass(frozen=True)
class BertConfig:
    """bert-base-uncased's shape by default (the reference's fields)."""
    vocab_size: int = 30522
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @staticmethod
    def tiny_test(**kw):
        return BertConfig(**{**dict(vocab_size=100, n_layers=2, n_heads=4,
                                    d_model=64, d_ff=128, max_seq_len=64),
                             **kw})


def layer_norm(x, scale, bias, eps):
    """The reference's own LayerNorm (bert.py:80-84, tts.py:92-96):
    statistics in x's dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class Bert:
    def __init__(self, config: BertConfig):
        self.config = config

    def init_params(self, seed=0, device="cuda") -> dict:
        """Random demo weights in the reference's numpy ``RandomState``
        order (bert.py:45-78): seed 0 gives the JAX package's
        ``init_params`` exactly."""
        cfg = self.config
        rng = np.random.RandomState(seed)
        d, dff = cfg.d_model, cfg.d_ff

        def dense(*shape):
            return (rng.randn(*shape) * 0.02).astype(np.float32)

        def zeros(n):
            return np.zeros(n, np.float32)

        params = {
            "tok_embed": dense(cfg.vocab_size, d),
            "pos_embed": dense(cfg.max_seq_len, d),
            "type_embed": dense(cfg.type_vocab_size, d),
            "embed_ln_scale": np.ones(d, np.float32),
            "embed_ln_bias": zeros(d),
            "pooler_w": dense(d, d), "pooler_b": zeros(d),
            "qa_w": dense(d, 2), "qa_b": zeros(2),
            "layers": [],
        }
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "wq": dense(d, d), "bq": zeros(d),
                "wk": dense(d, d), "bk": zeros(d),
                "wv": dense(d, d), "bv": zeros(d),
                "wo": dense(d, d), "bo": zeros(d),
                "attn_ln_scale": np.ones(d, np.float32),
                "attn_ln_bias": zeros(d),
                "w_up": dense(d, dff), "b_up": zeros(dff),
                "w_down": dense(dff, d), "b_down": zeros(d),
                "mlp_ln_scale": np.ones(d, np.float32),
                "mlp_ln_bias": zeros(d),
            })
        return params_from_numpy(params, device)

    def _ln(self, x, scale, bias):
        return layer_norm(x, scale, bias, self.config.layer_norm_eps)

    def forward(self, params, input_ids, attention_mask=None,
                token_type_ids=None):
        """input_ids [B, S]; attention_mask [B, S] (1 for tokens, 0 for
        right padding) or None. Returns hidden states f32 [B, S, d]."""
        s = input_ids.shape[1]
        x = params["tok_embed"][input_ids.to(torch.int64)]
        x = x + params["pos_embed"][None, :s]
        if token_type_ids is not None:
            x = x + params["type_embed"][token_type_ids.to(torch.int64)]
        else:
            x = x + params["type_embed"][0]
        x = self._ln(x, params["embed_ln_scale"], params["embed_ln_bias"])
        lengths = None
        if attention_mask is not None:
            lengths = attention_mask.to(torch.int32).sum(dim=-1)
        return self.encode_embeddings(params, x, lengths=lengths)

    def encode_embeddings(self, params, x, lengths=None):
        """The encoder stack over embeddings [B, S, d] (the same blocks
        serve non-token inputs, e.g. acoustic frames before CTC);
        ``lengths`` [B] masks the keys past each sequence's length."""
        cfg = self.config
        b, s, _ = x.shape
        scale = 1.0 / math.sqrt(cfg.head_dim)

        def heads(t):
            return t.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

        with full_f32():
            for layer in params["layers"]:
                q = linear(x, layer["wq"], layer["bq"])
                k = linear(x, layer["wk"], layer["bk"])
                v = linear(x, layer["wv"], layer["bv"])
                out = attn_reference(heads(q), heads(k), heads(v), False,
                                     scale, lengths)
                out = out.transpose(1, 2).reshape(b, s, cfg.d_model)
                attn = linear(out, layer["wo"], layer["bo"])
                x = self._ln(x + attn, layer["attn_ln_scale"],
                             layer["attn_ln_bias"])
                h = F.gelu(linear(x, layer["w_up"], layer["b_up"]),
                           approximate="none")
                mlp = linear(h, layer["w_down"], layer["b_down"])
                x = self._ln(x + mlp, layer["mlp_ln_scale"],
                             layer["mlp_ln_bias"])
        return x

    def pooled(self, params, input_ids, attention_mask=None):
        """[CLS] pooler output [B, d] (classification / similarity)."""
        hidden = self.forward(params, input_ids, attention_mask)
        with full_f32():
            return torch.tanh(linear(hidden[:, 0], params["pooler_w"],
                                     params["pooler_b"]))

    def qa_spans(self, params, input_ids, attention_mask=None,
                 token_type_ids=None):
        """(start_logits, end_logits) [B, S] for extractive QA;
        ``token_type_ids`` separates question (0) from context (1)."""
        hidden = self.forward(params, input_ids, attention_mask,
                              token_type_ids=token_type_ids)
        with full_f32():
            logits = linear(hidden, params["qa_w"], params["qa_b"])
        return logits[..., 0], logits[..., 1]

    def mean_embedding(self, params, input_ids, attention_mask=None):
        """Mean-pooled sentence embedding [B, d] over the unmasked
        tokens."""
        hidden = self.forward(params, input_ids, attention_mask)
        if attention_mask is None:
            return hidden.mean(dim=1)
        mask = attention_mask[..., None].to(hidden.dtype)
        return (hidden * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1),
                                                        min=1.0)
