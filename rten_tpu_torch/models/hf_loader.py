"""Hugging Face checkpoint loaders: map GPT-2, Llama-family, Mixtral,
Whisper and BERT state dicts onto the port's parameter trees.

A copy of ``rten_tpu/models/hf_loader.py``. The loaders return numpy
trees, as the reference's do, which
:func:`rten_tpu_torch.models.convert.params_from_numpy` puts on a device.
Sources accepted: a mapping of tensors or arrays, a module with
``state_dict()``, or a ``.safetensors`` / torch ``.bin`` file path.
"""

from __future__ import annotations

import numpy as np
import torch

from .bert import BertConfig
from .encoder_decoder import EncoderDecoderConfig
from .transformer import TransformerConfig


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().astype(np.float32)
    return np.asarray(t, np.float32)


def load_state_dict(source) -> dict:
    """Accepts a path (.safetensors / torch .bin) or a mapping/torch
    module; returns {name: numpy array}."""
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    if isinstance(source, dict):
        return {k: _np(v) for k, v in source.items()}
    path = str(source)
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return {k: np.asarray(v, np.float32)
                for k, v in load_file(path).items()}
    return {k: _np(v) for k, v in
            torch.load(path, map_location="cpu").items()}


def _strip_prefix(sd, prefixes=("transformer.", "model.", "bert.")):
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):] if k.startswith(prefix) else k: v
                    for k, v in sd.items()}
    return sd


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

def gpt2_config_from_hf(hf_config) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=hf_config.vocab_size, n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head, d_model=hf_config.n_embd,
        d_ff=4 * hf_config.n_embd, max_seq_len=hf_config.n_positions,
        pos="learned", norm="layernorm", act="gelu", tie_embeddings=True,
        layer_norm_eps=hf_config.layer_norm_epsilon)


def load_gpt2(source, config: TransformerConfig) -> dict:
    """HF GPT-2 state dict → TransformerLM params. Note GPT-2's Conv1D
    stores weights [in, out] — exactly our layout, no transpose."""
    sd = _strip_prefix(load_state_dict(source))
    d = config.d_model
    params = {
        "embed": sd["wte.weight"],
        "pos_embed": sd["wpe.weight"],
        "ln_f_scale": sd["ln_f.weight"],
        "ln_f_bias": sd["ln_f.bias"],
        "layers": [],
    }
    for i in range(config.n_layers):
        p = f"h.{i}."
        params["layers"].append({
            "ln1_scale": sd[p + "ln_1.weight"],
            "ln1_bias": sd[p + "ln_1.bias"],
            # GPT-2's c_attn is already the fused [q|k|v] layout.
            "wqkv": sd[p + "attn.c_attn.weight"],
            "bqkv": sd[p + "attn.c_attn.bias"],
            "wo": sd[p + "attn.c_proj.weight"],
            "bo": sd[p + "attn.c_proj.bias"],
            "ln2_scale": sd[p + "ln_2.weight"],
            "ln2_bias": sd[p + "ln_2.bias"],
            "w_up": sd[p + "mlp.c_fc.weight"],
            "b_up": sd[p + "mlp.c_fc.bias"],
            "w_down": sd[p + "mlp.c_proj.weight"],
            "b_down": sd[p + "mlp.c_proj.bias"],
        })
    return params


# ---------------------------------------------------------------------------
# Llama family (TinyLlama, Qwen2-without-bias, ...)
# ---------------------------------------------------------------------------

def llama_config_from_hf(hf_config) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        kv_heads=hf_config.num_key_value_heads,
        d_model=hf_config.hidden_size, d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings, pos="rope",
        norm="rmsnorm", act="swiglu",
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        layer_norm_eps=hf_config.rms_norm_eps)


def load_llama(source, config: TransformerConfig) -> dict:
    """HF Llama state dict → TransformerLM params (nn.Linear stores
    [out, in] — transpose into our [in, out])."""
    sd = _strip_prefix(load_state_dict(source))
    params = {
        "embed": sd["embed_tokens.weight"],
        "ln_f_scale": sd["norm.weight"],
        "layers": [],
    }
    if not config.tie_embeddings:
        lm = sd.get("lm_head.weight")
        if lm is None:
            raise KeyError("lm_head.weight missing for untied model")
        params["lm_head"] = lm.T
    for i in range(config.n_layers):
        p = f"layers.{i}."
        params["layers"].append({
            "ln1_scale": sd[p + "input_layernorm.weight"],
            "wqkv": np.concatenate(
                [sd[p + "self_attn.q_proj.weight"].T,
                 sd[p + "self_attn.k_proj.weight"].T,
                 sd[p + "self_attn.v_proj.weight"].T], axis=1),
            "wo": sd[p + "self_attn.o_proj.weight"].T,
            "ln2_scale": sd[p + "post_attention_layernorm.weight"],
            "w_gate": sd[p + "mlp.gate_proj.weight"].T,
            "w_up": sd[p + "mlp.up_proj.weight"].T,
            "w_down": sd[p + "mlp.down_proj.weight"].T,
        })
    return params


# ---------------------------------------------------------------------------
# Mixtral (Llama attention + sparse MoE MLP)
# ---------------------------------------------------------------------------

def mixtral_config_from_hf(hf_config) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        kv_heads=hf_config.num_key_value_heads,
        d_model=hf_config.hidden_size, d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings, pos="rope",
        norm="rmsnorm", act="swiglu",
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        rope_theta=getattr(hf_config, "rope_theta", 1e6),
        layer_norm_eps=hf_config.rms_norm_eps,
        n_experts=hf_config.num_local_experts,
        experts_per_token=hf_config.num_experts_per_tok)


def load_mixtral(source, config: TransformerConfig) -> dict:
    """HF Mixtral state dict → TransformerLM params. Experts stack into
    [E, in, out] arrays (HF w1 = gate, w3 = up, w2 = down, each
    [out, in])."""
    sd = _strip_prefix(load_state_dict(source))
    params = {
        "embed": sd["embed_tokens.weight"],
        "ln_f_scale": sd["norm.weight"],
        "layers": [],
    }
    if not config.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T

    def experts(m, w):
        return np.stack([sd[m + f"experts.{j}.{w}.weight"].T
                         for j in range(config.n_experts)])

    for i in range(config.n_layers):
        p = f"layers.{i}."
        m = p + "block_sparse_moe."
        params["layers"].append({
            "ln1_scale": sd[p + "input_layernorm.weight"],
            "wqkv": np.concatenate(
                [sd[p + "self_attn.q_proj.weight"].T,
                 sd[p + "self_attn.k_proj.weight"].T,
                 sd[p + "self_attn.v_proj.weight"].T], axis=1),
            "wo": sd[p + "self_attn.o_proj.weight"].T,
            "ln2_scale": sd[p + "post_attention_layernorm.weight"],
            "router": sd[m + "gate.weight"].T,
            "w_gate": experts(m, "w1"),
            "w_up": experts(m, "w3"),
            "w_down": experts(m, "w2"),
        })
    return params


# ---------------------------------------------------------------------------
# Whisper (encoder-decoder)
# ---------------------------------------------------------------------------

def whisper_config_from_hf(hf_config) -> EncoderDecoderConfig:
    return EncoderDecoderConfig(
        vocab_size=hf_config.vocab_size,
        n_enc_layers=hf_config.encoder_layers,
        n_dec_layers=hf_config.decoder_layers,
        n_heads=hf_config.encoder_attention_heads,
        d_model=hf_config.d_model,
        d_ff=hf_config.encoder_ffn_dim,
        n_mels=hf_config.num_mel_bins,
        max_source_len=hf_config.max_source_positions,
        max_target_len=hf_config.max_target_positions,
        conv_frontend=True)


def load_whisper(source, config: EncoderDecoderConfig) -> dict:
    """HF ``WhisperForConditionalGeneration`` state dict →
    :class:`~rten_tpu_torch.models.encoder_decoder.EncoderDecoderLM`
    params. torch Conv1d weights [out, in, k] transpose to [k, in, out],
    nn.Linear [out, in] to [in, out]; Whisper's k_proj has no bias (the
    model reads bq/bv/bo where present); proj_out is tied to the decoder
    embedding (the logits head is ``tgt_embed.T``)."""
    sd = _strip_prefix(load_state_dict(source))

    def attn(p, cross=False):
        name = "encoder_attn" if cross else "self_attn"
        return {
            "wq": sd[f"{p}{name}.q_proj.weight"].T,
            "bq": sd[f"{p}{name}.q_proj.bias"],
            "wk": sd[f"{p}{name}.k_proj.weight"].T,
            "wv": sd[f"{p}{name}.v_proj.weight"].T,
            "bv": sd[f"{p}{name}.v_proj.bias"],
            "wo": sd[f"{p}{name}.out_proj.weight"].T,
            "bo": sd[f"{p}{name}.out_proj.bias"],
            "ln_scale": sd[f"{p}{name}_layer_norm.weight"],
            "ln_bias": sd[f"{p}{name}_layer_norm.bias"],
        }

    def mlp(p):
        return {
            "ln_scale": sd[p + "final_layer_norm.weight"],
            "ln_bias": sd[p + "final_layer_norm.bias"],
            "w_up": sd[p + "fc1.weight"].T,
            "b_up": sd[p + "fc1.bias"],
            "w_down": sd[p + "fc2.weight"].T,
            "b_down": sd[p + "fc2.bias"],
        }

    params = {
        "conv1_w": sd["encoder.conv1.weight"].transpose(2, 1, 0),
        "conv1_b": sd["encoder.conv1.bias"],
        "conv2_w": sd["encoder.conv2.weight"].transpose(2, 1, 0),
        "conv2_b": sd["encoder.conv2.bias"],
        "src_proj": np.zeros((config.n_mels, config.d_model), np.float32),
        "src_pos": sd["encoder.embed_positions.weight"],
        "tgt_embed": sd["decoder.embed_tokens.weight"],
        "tgt_pos": sd["decoder.embed_positions.weight"],
        "enc_ln_scale": sd["encoder.layer_norm.weight"],
        "enc_ln_bias": sd["encoder.layer_norm.bias"],
        "dec_ln_scale": sd["decoder.layer_norm.weight"],
        "dec_ln_bias": sd["decoder.layer_norm.bias"],
        "encoder": [], "decoder": [],
    }
    for i in range(config.n_enc_layers):
        p = f"encoder.layers.{i}."
        params["encoder"].append({"attn": attn(p), "mlp": mlp(p)})
    for i in range(config.n_dec_layers):
        p = f"decoder.layers.{i}."
        params["decoder"].append({"self_attn": attn(p),
                                  "cross_attn": attn(p, cross=True),
                                  "mlp": mlp(p)})
    return params


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def bert_config_from_hf(hf_config) -> BertConfig:
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_model=hf_config.hidden_size,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps)


def load_bert(source, config: BertConfig) -> dict:
    """HF BERT state dict (``BertModel``, ``BertForQuestionAnswering``)
    → :class:`~rten_tpu_torch.models.bert.Bert` params; a missing pooler
    becomes the identity, a missing QA head zeros."""
    sd = _strip_prefix(load_state_dict(source))
    params = {
        "tok_embed": sd["embeddings.word_embeddings.weight"],
        "pos_embed": sd["embeddings.position_embeddings.weight"],
        "type_embed": sd["embeddings.token_type_embeddings.weight"],
        "embed_ln_scale": sd["embeddings.LayerNorm.weight"],
        "embed_ln_bias": sd["embeddings.LayerNorm.bias"],
        "pooler_w": sd["pooler.dense.weight"].T
        if "pooler.dense.weight" in sd else np.eye(config.d_model,
                                                   dtype=np.float32),
        "pooler_b": sd.get("pooler.dense.bias",
                           np.zeros(config.d_model, np.float32)),
        "qa_w": sd.get("qa_outputs.weight",
                       np.zeros((2, config.d_model), np.float32)).T,
        "qa_b": sd.get("qa_outputs.bias", np.zeros(2, np.float32)),
        "layers": [],
    }
    for i in range(config.n_layers):
        p = f"encoder.layer.{i}."
        params["layers"].append({
            "wq": sd[p + "attention.self.query.weight"].T,
            "bq": sd[p + "attention.self.query.bias"],
            "wk": sd[p + "attention.self.key.weight"].T,
            "bk": sd[p + "attention.self.key.bias"],
            "wv": sd[p + "attention.self.value.weight"].T,
            "bv": sd[p + "attention.self.value.bias"],
            "wo": sd[p + "attention.output.dense.weight"].T,
            "bo": sd[p + "attention.output.dense.bias"],
            "attn_ln_scale": sd[p + "attention.output.LayerNorm.weight"],
            "attn_ln_bias": sd[p + "attention.output.LayerNorm.bias"],
            "w_up": sd[p + "intermediate.dense.weight"].T,
            "b_up": sd[p + "intermediate.dense.bias"],
            "w_down": sd[p + "output.dense.weight"].T,
            "b_down": sd[p + "output.dense.bias"],
            "mlp_ln_scale": sd[p + "output.LayerNorm.weight"],
            "mlp_ln_bias": sd[p + "output.LayerNorm.bias"],
        })
    return params
