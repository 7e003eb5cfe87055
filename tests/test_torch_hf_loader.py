"""The port's Hugging Face loaders (``rten_tpu_torch/models/hf_loader.py``)
against the JAX package's on the CPU: synthetic HF-named GPT-2, Llama and
Mixtral state dicts, given as a dict, a ``torch.save`` file and a
``.safetensors`` file, give the reference's numpy trees bit for bit (a
Mixtral tree also the reference's logits); the configs from an HF config
equal the reference's; ``serve --weights`` serves such a file; with
``transformers`` installed, a Mixtral model's logits equal
``MixtralForCausalLM``'s. Whisper and BERT state dicts (dict, ``torch.save``
and ``.safetensors``) give the reference's trees bit for bit, and the
loaded trees the reference's logits and hidden states."""

import argparse
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from rten_tpu.models import hf_loader as ref_loader
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.models import hf_loader, params_from_numpy
from rten_tpu_torch.models import transformer as ptr

GPT2 = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=64, d_ff=256,
            max_seq_len=48)
LLAMA = dict(vocab_size=80, n_layers=2, n_heads=4, kv_heads=2, d_model=64,
             d_ff=96, max_seq_len=64, pos="rope", norm="rmsnorm",
             act="swiglu")


def _gpt2_state_dict(seed, dtype=torch.float32):
    """HF GPT-2 names (Conv1D weights [in, out]) under ``transformer.``."""
    g = torch.Generator().manual_seed(seed)
    d, f = GPT2["d_model"], GPT2["d_ff"]

    def t(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    sd = {"transformer.wte.weight": t(GPT2["vocab_size"], d),
          "transformer.wpe.weight": t(GPT2["max_seq_len"], d),
          "transformer.ln_f.weight": t(d), "transformer.ln_f.bias": t(d)}
    for i in range(GPT2["n_layers"]):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": t(d), p + "ln_1.bias": t(d),
                   p + "attn.c_attn.weight": t(d, 3 * d),
                   p + "attn.c_attn.bias": t(3 * d),
                   p + "attn.c_proj.weight": t(d, d),
                   p + "attn.c_proj.bias": t(d),
                   p + "ln_2.weight": t(d), p + "ln_2.bias": t(d),
                   p + "mlp.c_fc.weight": t(d, f), p + "mlp.c_fc.bias": t(f),
                   p + "mlp.c_proj.weight": t(f, d),
                   p + "mlp.c_proj.bias": t(d)})
    return sd


def _llama_state_dict(seed, tied=False):
    """HF Llama names (nn.Linear weights [out, in]) under ``model.``."""
    g = torch.Generator().manual_seed(seed)
    d, f = LLAMA["d_model"], LLAMA["d_ff"]
    hd = d // LLAMA["n_heads"]
    kv = LLAMA["kv_heads"] * hd

    def t(*shape):
        return torch.randn(*shape, generator=g)

    sd = {"model.embed_tokens.weight": t(LLAMA["vocab_size"], d),
          "model.norm.weight": t(d)}
    if not tied:
        sd["lm_head.weight"] = t(LLAMA["vocab_size"], d)
    for i in range(LLAMA["n_layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": t(d),
                   p + "self_attn.q_proj.weight": t(d, d),
                   p + "self_attn.k_proj.weight": t(kv, d),
                   p + "self_attn.v_proj.weight": t(kv, d),
                   p + "self_attn.o_proj.weight": t(d, d),
                   p + "post_attention_layernorm.weight": t(d),
                   p + "mlp.gate_proj.weight": t(f, d),
                   p + "mlp.up_proj.weight": t(f, d),
                   p + "mlp.down_proj.weight": t(d, f)})
    return sd


def _source(sd, kind, tmp_path):
    if kind == "dict":
        return sd
    if kind == "module":
        return types.SimpleNamespace(state_dict=lambda: sd)
    if kind == "torch_save":
        path = tmp_path / "pytorch_model.bin"
        torch.save(sd, path)
        return str(path)
    from safetensors.torch import save_file
    path = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    return str(path)


def _assert_same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_tree(a, b)
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert np.array_equal(got, want)    # bit for bit (no NaNs here)


SOURCES = ["dict", "module", "torch_save", "safetensors"]


@pytest.mark.parametrize("source", SOURCES)
def test_load_gpt2_equals_reference(source, tmp_path):
    sd = _gpt2_state_dict(0)
    src = _source(sd, source, tmp_path)
    got = hf_loader.load_gpt2(src, ptr.TransformerConfig.tiny_test(**GPT2))
    want = ref_loader.load_gpt2(src, jtr.TransformerConfig.tiny_test(**GPT2))
    _assert_same_tree(got, want)


def test_load_gpt2_half_precision_dict_equals_reference():
    sd = _gpt2_state_dict(1, dtype=torch.float16)
    got = hf_loader.load_gpt2(sd, ptr.TransformerConfig.tiny_test(**GPT2))
    want = ref_loader.load_gpt2(sd, jtr.TransformerConfig.tiny_test(**GPT2))
    _assert_same_tree(got, want)
    assert got["embed"].dtype == np.float32


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("source", SOURCES)
def test_load_llama_equals_reference(source, tied, tmp_path):
    sd = _llama_state_dict(2, tied=tied)
    src = _source(sd, source, tmp_path)
    kw = dict(LLAMA, tie_embeddings=tied)
    got = hf_loader.load_llama(src, ptr.TransformerConfig.tiny_test(**kw))
    want = ref_loader.load_llama(src, jtr.TransformerConfig.tiny_test(**kw))
    _assert_same_tree(got, want)


def test_load_llama_untied_without_head_raises():
    sd = _llama_state_dict(3, tied=True)
    with pytest.raises(KeyError, match="lm_head"):
        hf_loader.load_llama(sd, ptr.TransformerConfig.tiny_test(
            **LLAMA, tie_embeddings=False))


def test_load_state_dict_equals_reference(tmp_path):
    sd = _gpt2_state_dict(4)
    for kind in SOURCES:
        src = _source(sd, kind, tmp_path)
        _assert_same_tree(hf_loader.load_state_dict(src),
                          ref_loader.load_state_dict(src))


def _same_config(got, want):
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_configs_from_hf_equal_reference():
    gpt2 = types.SimpleNamespace(vocab_size=50257, n_layer=12, n_head=12,
                                 n_embd=768, n_positions=1024,
                                 layer_norm_epsilon=1e-5)
    _same_config(hf_loader.gpt2_config_from_hf(gpt2),
                 ref_loader.gpt2_config_from_hf(gpt2))
    llama = types.SimpleNamespace(
        vocab_size=32000, num_hidden_layers=22, num_attention_heads=32,
        num_key_value_heads=4, hidden_size=2048, intermediate_size=5632,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=1e4,
        tie_word_embeddings=False)
    _same_config(hf_loader.llama_config_from_hf(llama),
                 ref_loader.llama_config_from_hf(llama))
    assert hf_loader.llama_config_from_hf(llama) == \
        ptr.TransformerConfig.tiny_llama()


def test_serve_weights_flag_serves_a_state_dict_file(tmp_path, monkeypatch):
    """``serve --weights FILE`` (build_engine) loads an HF GPT-2 file into
    the engine: with the GPT-2 config cut to the synthetic dict's size, its
    greedy tokens equal the reference engine's on the reference loader's
    tree."""
    from rten_tpu.generate.engine import ServingEngine as JServingEngine
    from rten_tpu_torch.serve import build_engine

    src = _source(_gpt2_state_dict(5), "safetensors", tmp_path)
    monkeypatch.setattr(ptr.TransformerConfig, "gpt2", staticmethod(
        lambda **kw: ptr.TransformerConfig.tiny_test(**GPT2)))
    args = argparse.Namespace(
        weights=src, demo=False, quantize=None, tokenizer=None,
        fixed_greedy=True, spec_draft=0, kv_cache=None, mesh=None,
        max_batch=2, capacity=32, paged=False, page_size=64,
        logprobs=False, overlap=False, device="cpu")
    engine, _ = build_engine(args)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**GPT2))
    jp = jax.tree_util.tree_map(jax.numpy.asarray, ref_loader.load_gpt2(
        src, jm.config))
    ref = JServingEngine(jm, jp, max_batch=2, capacity=32, cache="f32")
    prompts = [[1, 2, 3], [50, 7]]
    assert engine.generate(prompts, max_new_tokens=5) == ref.generate(
        prompts, max_new_tokens=5)


# -- Mixtral ------------------------------------------------------------------

MIXTRAL = dict(vocab_size=72, n_layers=2, n_heads=4, kv_heads=2, d_model=48,
               d_ff=64, max_seq_len=64, pos="rope", norm="rmsnorm",
               act="swiglu", tie_embeddings=False, n_experts=4,
               experts_per_token=2)


def _mixtral_state_dict(seed):
    """HF Mixtral names under ``model.``: Llama attention, a router
    (``block_sparse_moe.gate``) and experts w1 (gate), w3 (up), w2 (down),
    each nn.Linear [out, in]."""
    g = torch.Generator().manual_seed(seed)
    d, f, e = MIXTRAL["d_model"], MIXTRAL["d_ff"], MIXTRAL["n_experts"]
    kv = MIXTRAL["kv_heads"] * d // MIXTRAL["n_heads"]

    def t(*shape):
        return 0.2 * torch.randn(*shape, generator=g)

    sd = {"model.embed_tokens.weight": t(MIXTRAL["vocab_size"], d),
          "model.norm.weight": 1 + t(d),
          "lm_head.weight": t(MIXTRAL["vocab_size"], d)}
    for i in range(MIXTRAL["n_layers"]):
        p = f"model.layers.{i}."
        m = p + "block_sparse_moe."
        sd.update({p + "input_layernorm.weight": 1 + t(d),
                   p + "self_attn.q_proj.weight": t(d, d),
                   p + "self_attn.k_proj.weight": t(kv, d),
                   p + "self_attn.v_proj.weight": t(kv, d),
                   p + "self_attn.o_proj.weight": t(d, d),
                   p + "post_attention_layernorm.weight": 1 + t(d),
                   m + "gate.weight": t(e, d)})
        for j in range(e):
            sd.update({m + f"experts.{j}.w1.weight": t(f, d),
                       m + f"experts.{j}.w3.weight": t(f, d),
                       m + f"experts.{j}.w2.weight": t(d, f)})
    return sd


@pytest.mark.parametrize("source", SOURCES)
def test_load_mixtral_equals_reference(source, tmp_path):
    """load_mixtral gives the reference's numpy tree bit for bit: expert
    stacks [E, in, out] (w1 gate, w3 up, w2 down), the router [d, E]."""
    src = _source(_mixtral_state_dict(6), source, tmp_path)
    got = hf_loader.load_mixtral(src, ptr.TransformerConfig(**MIXTRAL))
    want = ref_loader.load_mixtral(src, jtr.TransformerConfig(**MIXTRAL))
    _assert_same_tree(got, want)
    layer = got["layers"][0]
    assert layer["w_gate"].shape == (4, 48, 64)
    assert layer["w_down"].shape == (4, 64, 48)
    assert layer["router"].shape == (48, 4)


@pytest.mark.parametrize("moe_impl", ["auto", "ragged"])
def test_load_mixtral_logits_match_reference(moe_impl):
    """The loaded tree through both packages' models: the same logits
    (f32 sums in other orders, |logits| ~ 3: within 1e-5)."""
    sd = _mixtral_state_dict(7)
    cfg = dict(MIXTRAL, moe_impl=moe_impl)
    tree = hf_loader.load_mixtral(sd, ptr.TransformerConfig(**cfg))
    ids = np.random.default_rng(1).integers(0, 72, (2, 10))
    want, _ = jtr.TransformerLM(jtr.TransformerConfig(**cfg)).forward(
        jax.tree_util.tree_map(jax.numpy.asarray, tree),
        jax.numpy.asarray(ids, jax.numpy.int32))
    got, _ = ptr.TransformerLM(ptr.TransformerConfig(**cfg)).forward(
        params_from_numpy(tree, device="cpu"), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_mixtral_config_from_hf_equals_reference():
    hf = types.SimpleNamespace(
        vocab_size=32000, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, hidden_size=4096, intermediate_size=14336,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=1e6,
        tie_word_embeddings=False, num_local_experts=8,
        num_experts_per_tok=2)
    got = hf_loader.mixtral_config_from_hf(hf)
    _same_config(got, ref_loader.mixtral_config_from_hf(hf))
    assert got == ptr.TransformerConfig.mixtral(layer_norm_eps=1e-5)


def test_mixtral_hf_parity(tmp_path):
    """tests/test_moe.py's HF parity on the port: the port's Mixtral
    logits against MixtralForCausalLM's, dense and ragged experts (needs
    ``transformers``; the port never imports it)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=96, hidden_size=48, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rope_theta=10000.0,
        attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg).eval()
    cfg = hf_loader.mixtral_config_from_hf(hf_cfg)
    assert cfg.n_experts == 4 and cfg.experts_per_token == 2
    params = params_from_numpy(hf_loader.load_mixtral(hf, cfg), device="cpu")
    ids = np.random.RandomState(7).randint(0, 96, (2, 10))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    for impl in ("auto", "ragged"):
        model = ptr.TransformerLM(dataclasses.replace(cfg, moe_impl=impl))
        got, _ = model.forward(params, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)


# -- Whisper and BERT ---------------------------------------------------------

WHISPER = dict(vocab_size=56, n_enc_layers=2, n_dec_layers=2, n_heads=4,
               d_model=32, d_ff=48, n_mels=8, max_source_len=12,
               max_target_len=16, conv_frontend=True)
BERT = dict(vocab_size=60, n_layers=2, n_heads=4, d_model=32, d_ff=48,
            max_seq_len=20)


def _whisper_state_dict(seed):
    """HF ``WhisperForConditionalGeneration`` names under ``model.``
    (Conv1d [out, in, k], nn.Linear [out, in], k_proj without a bias) and
    the tied ``proj_out``."""
    g = torch.Generator().manual_seed(seed)
    d, f = WHISPER["d_model"], WHISPER["d_ff"]

    def t(*shape):
        return 0.2 * torch.randn(*shape, generator=g)

    def attn(p, name):
        out = {f"{p}{name}.{w}_proj.weight": t(d, d) for w in "qkv"}
        out[f"{p}{name}.out_proj.weight"] = t(d, d)
        out.update({f"{p}{name}.q_proj.bias": t(d),
                    f"{p}{name}.v_proj.bias": t(d),
                    f"{p}{name}.out_proj.bias": t(d),
                    f"{p}{name}_layer_norm.weight": 1 + t(d),
                    f"{p}{name}_layer_norm.bias": t(d)})
        return out

    def mlp(p):
        return {p + "final_layer_norm.weight": 1 + t(d),
                p + "final_layer_norm.bias": t(d),
                p + "fc1.weight": t(f, d), p + "fc1.bias": t(f),
                p + "fc2.weight": t(d, f), p + "fc2.bias": t(d)}

    m = "model."
    sd = {m + "encoder.conv1.weight": t(d, WHISPER["n_mels"], 3),
          m + "encoder.conv1.bias": t(d),
          m + "encoder.conv2.weight": t(d, d, 3),
          m + "encoder.conv2.bias": t(d),
          m + "encoder.embed_positions.weight": t(WHISPER["max_source_len"],
                                                  d),
          m + "encoder.layer_norm.weight": 1 + t(d),
          m + "encoder.layer_norm.bias": t(d),
          m + "decoder.embed_tokens.weight": t(WHISPER["vocab_size"], d),
          m + "decoder.embed_positions.weight": t(WHISPER["max_target_len"],
                                                  d),
          m + "decoder.layer_norm.weight": 1 + t(d),
          m + "decoder.layer_norm.bias": t(d)}
    for i in range(WHISPER["n_enc_layers"]):
        p = f"{m}encoder.layers.{i}."
        sd.update({**attn(p, "self_attn"), **mlp(p)})
    for i in range(WHISPER["n_dec_layers"]):
        p = f"{m}decoder.layers.{i}."
        sd.update({**attn(p, "self_attn"), **attn(p, "encoder_attn"),
                   **mlp(p)})
    sd["proj_out.weight"] = sd[m + "decoder.embed_tokens.weight"].clone()
    return sd


def _bert_state_dict(seed, heads=True):
    """HF BERT names under ``bert.`` (nn.Linear [out, in]); with ``heads``
    the pooler and a QA head (``qa_outputs``, outside the prefix)."""
    g = torch.Generator().manual_seed(seed)
    d, f = BERT["d_model"], BERT["d_ff"]

    def t(*shape):
        return 0.2 * torch.randn(*shape, generator=g)

    b = "bert."
    sd = {b + "embeddings.word_embeddings.weight": t(BERT["vocab_size"], d),
          b + "embeddings.position_embeddings.weight": t(BERT["max_seq_len"],
                                                         d),
          b + "embeddings.token_type_embeddings.weight": t(2, d),
          b + "embeddings.LayerNorm.weight": 1 + t(d),
          b + "embeddings.LayerNorm.bias": t(d)}
    for i in range(BERT["n_layers"]):
        p = f"{b}encoder.layer.{i}."
        for w in ("query", "key", "value"):
            sd[f"{p}attention.self.{w}.weight"] = t(d, d)
            sd[f"{p}attention.self.{w}.bias"] = t(d)
        sd.update({p + "attention.output.dense.weight": t(d, d),
                   p + "attention.output.dense.bias": t(d),
                   p + "attention.output.LayerNorm.weight": 1 + t(d),
                   p + "attention.output.LayerNorm.bias": t(d),
                   p + "intermediate.dense.weight": t(f, d),
                   p + "intermediate.dense.bias": t(f),
                   p + "output.dense.weight": t(d, f),
                   p + "output.dense.bias": t(d),
                   p + "output.LayerNorm.weight": 1 + t(d),
                   p + "output.LayerNorm.bias": t(d)})
    if heads:
        sd.update({b + "pooler.dense.weight": t(d, d),
                   b + "pooler.dense.bias": t(d),
                   "qa_outputs.weight": t(2, d), "qa_outputs.bias": t(2)})
    return sd


FILE_SOURCES = ["dict", "torch_save", "safetensors"]


@pytest.mark.parametrize("source", FILE_SOURCES)
def test_load_whisper_equals_reference(source, tmp_path):
    from rten_tpu.models.encoder_decoder import EncoderDecoderConfig as JCfg
    from rten_tpu_torch.models import EncoderDecoderConfig
    src = _source(_whisper_state_dict(8), source, tmp_path)
    got = hf_loader.load_whisper(src, EncoderDecoderConfig(**WHISPER))
    want = ref_loader.load_whisper(src, JCfg(**WHISPER))
    _assert_same_tree(got, want)
    assert got["conv1_w"].shape == (3, 8, 32)


@pytest.mark.parametrize("source", FILE_SOURCES)
def test_load_bert_equals_reference(source, tmp_path):
    from rten_tpu.models.bert import BertConfig as JCfg
    from rten_tpu_torch.models import BertConfig
    src = _source(_bert_state_dict(9), source, tmp_path)
    got = hf_loader.load_bert(src, BertConfig(**BERT))
    want = ref_loader.load_bert(src, JCfg(**BERT))
    _assert_same_tree(got, want)


def test_load_bert_without_heads_equals_reference():
    """A bare ``BertModel`` dict without pooler or QA head: the identity
    pooler and a zero QA head, as in the reference."""
    from rten_tpu.models.bert import BertConfig as JCfg
    from rten_tpu_torch.models import BertConfig
    sd = _bert_state_dict(10, heads=False)
    got = hf_loader.load_bert(sd, BertConfig(**BERT))
    _assert_same_tree(got, ref_loader.load_bert(sd, JCfg(**BERT)))
    assert np.array_equal(got["pooler_w"], np.eye(32, dtype=np.float32))


def test_whisper_and_bert_configs_from_hf_equal_reference():
    whisper = types.SimpleNamespace(
        vocab_size=51865, encoder_layers=12, decoder_layers=12,
        encoder_attention_heads=12, d_model=768, encoder_ffn_dim=3072,
        num_mel_bins=80, max_source_positions=1500,
        max_target_positions=448)
    got = hf_loader.whisper_config_from_hf(whisper)
    _same_config(got, ref_loader.whisper_config_from_hf(whisper))
    from rten_tpu_torch.models import EncoderDecoderConfig
    assert got == EncoderDecoderConfig.whisper_small()
    bert = types.SimpleNamespace(
        vocab_size=30522, num_hidden_layers=12, num_attention_heads=12,
        hidden_size=768, intermediate_size=3072, max_position_embeddings=512,
        type_vocab_size=2, layer_norm_eps=1e-12)
    got = hf_loader.bert_config_from_hf(bert)
    _same_config(got, ref_loader.bert_config_from_hf(bert))
    from rten_tpu_torch.models import BertConfig
    assert got == BertConfig()


def test_loaded_whisper_logits_match_reference():
    """The loaded tree through both packages: encoder memory and the
    logits of a 3-token decode with an f32 cache (biases on q, v and out;
    none on k), within 1e-5."""
    from rten_tpu.models import encoder_decoder as jed
    from rten_tpu_torch.models import EncoderDecoderConfig, EncoderDecoderLM
    sd = _whisper_state_dict(11)
    pcfg = EncoderDecoderConfig(**WHISPER)
    tree = hf_loader.load_whisper(sd, pcfg)
    jm = jed.EncoderDecoderLM(jed.EncoderDecoderConfig(**WHISPER))
    pm = EncoderDecoderLM(pcfg)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    pp = params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 24, 8)).astype(np.float32)
    tokens = rng.integers(0, 56, (2, 3))
    jmem = jm.encode(jp, jax.numpy.asarray(feats))
    pmem = pm.encode(pp, torch.from_numpy(feats))
    np.testing.assert_allclose(pmem.numpy(), np.asarray(jmem), rtol=0,
                               atol=1e-5)
    want, _ = jm.decode(jp, jax.numpy.asarray(tokens, jax.numpy.int32),
                        jm.cross_kv(jp, jmem), jm.new_cache(2))
    got, _ = pm.decode(pp, torch.from_numpy(tokens), pm.cross_kv(pp, pmem),
                       pm.new_cache(2, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_loaded_bert_hidden_states_match_reference():
    """The loaded BERT tree (with its QA head) through both packages:
    hidden states and span logits with a padding mask, within 1e-5."""
    from rten_tpu.models import bert as jb
    from rten_tpu_torch.models import Bert, BertConfig
    tree = hf_loader.load_bert(_bert_state_dict(12), BertConfig(**BERT))
    jm, pm = jb.Bert(jb.BertConfig(**BERT)), Bert(BertConfig(**BERT))
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    pp = params_from_numpy(tree, device="cpu")
    ids = np.random.default_rng(3).integers(0, 60, (2, 10))
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    for got, want in zip(
            pm.qa_spans(pp, torch.from_numpy(ids), torch.from_numpy(mask)),
            jm.qa_spans(jp, jax.numpy.asarray(ids),
                        jax.numpy.asarray(mask))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
