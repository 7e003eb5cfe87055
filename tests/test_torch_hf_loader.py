"""The port's Hugging Face loaders (``rten_tpu_torch/models/hf_loader.py``)
against the JAX package's on the CPU: synthetic HF-named GPT-2, Llama and
Mixtral state dicts, given as a dict, a ``torch.save`` file and a
``.safetensors`` file, give the reference's numpy trees bit for bit (a
Mixtral tree also the reference's logits); the configs from an HF config
equal the reference's; ``serve --weights`` serves such a file; the
loaders not ported raise naming their ROADMAP.md items; with
``transformers`` installed, a Mixtral model's logits equal
``MixtralForCausalLM``'s."""

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


@pytest.mark.parametrize("name,item", [
    ("load_whisper", "other model families"),
    ("whisper_config_from_hf", "other model families"),
    ("load_bert", "other model families"),
    ("bert_config_from_hf", "other model families")])
def test_unported_loaders_raise_naming_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1, .*{item}"):
        getattr(hf_loader, name)({})


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
