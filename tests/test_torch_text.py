"""The port's tokenizers (``rten_tpu_torch/text``), ``TextDecoder`` and
``render_chat`` on the CPU: the golden ids of ``tests/data/text_reftests/``
(as ``tests/test_text_reftests.py`` checks them), ids and offsets equal to
the JAX package's tokenizers on the same strings, and the native BPE merge
loop (built into ``rten_tpu_torch/build/native/``) equal to the Python
one."""

import json
import pathlib

import pytest

from rten_tpu.generate.chat import render_chat as ref_render_chat
from rten_tpu.generate.text_decoder import TextDecoder as RefTextDecoder
from rten_tpu.text import from_json_file as ref_from_json_file
from rten_tpu.text import from_json_str as ref_from_json_str
from rten_tpu.text import wordpiece_from_vocab as ref_wordpiece
from rten_tpu_torch.generate.chat import TEMPLATES, render_chat
from rten_tpu_torch.generate.text_decoder import TextDecoder
from rten_tpu_torch.text import (from_json_file, from_json_str, native_bpe,
                                 wordpiece_from_vocab)

DATA = pathlib.Path(__file__).parent / "data" / "text_reftests"
CORPORA = ["Rust_(programming_language)", "monty-python-credits",
           "Metal_umlaut"]
STRINGS = ["The quick brown fox jumps over the lazy dog.",
           "Hello world! Ünïcödé † characters and    whitespace.",
           "  leading and trailing  ", "numbers 123 456 7890 !?;:,.",
           "naïve café — “quotes” 🙂 \x07 tab\tend", ""]


def _text(name):
    return (DATA / f"{name}.txt").read_text(encoding="utf-8")


def _golden(name):
    with open(DATA / name, encoding="utf-8") as f:
        return json.load(f)


TOKENIZERS = {
    "gpt2": lambda mod: mod[0](DATA / "models/gpt2/tokenizer.json"),
    "llama-32k": lambda mod: mod[0](DATA / "models/llama-32k/tokenizer.json"),
    "bert-base-uncased": lambda mod: mod[1](
        DATA / "models/bert-base-uncased/vocab.txt", lowercase=True),
    "bert-base-cased": lambda mod: mod[1](
        DATA / "models/bert-base-cased/vocab.txt", lowercase=False),
}
PORT = (from_json_file, wordpiece_from_vocab)
REF = (ref_from_json_file, ref_wordpiece)


@pytest.fixture(scope="module")
def port_toks():
    return {name: make(PORT) for name, make in TOKENIZERS.items()}


@pytest.fixture(scope="module")
def ref_toks():
    return {name: make(REF) for name, make in TOKENIZERS.items()}


# -- the golden files --------------------------------------------------------

GOLDEN = [(c, "gpt2") for c in ("monty-python-credits",)] \
    + [(c, "bert-base-uncased") for c in CORPORA] \
    + [("Rust_(programming_language)", "bert-base-cased")] \
    + [(c, "llama-32k") for c in CORPORA]


@pytest.mark.parametrize("corpus,table", GOLDEN)
def test_golden_ids(port_toks, corpus, table):
    """Every golden id file of tests/data/text_reftests/."""
    tok = port_toks[table]
    bert = table.startswith("bert")
    ids = tok.encode(_text(corpus), add_special=bert)
    assert ids == _golden(f"{corpus}-{table}.json")["token_ids"]


def test_golden_byte_fallback_stress(port_toks):
    golden = _golden("bytefallback-stress-llama-32k.json")
    tok = port_toks["llama-32k"]
    ids = tok.encode(golden["input_text"])
    assert ids == golden["token_ids"]
    assert tok.decode(ids) == golden["decoded"]


def test_golden_files_all_checked():
    names = {f"{c}-{t}.json" for c, t in GOLDEN} | {
        "bytefallback-stress-llama-32k.json"}
    assert names == {p.name for p in DATA.glob("*.json")}


# -- ids and offsets against the reference's tokenizers -------------------------

@pytest.mark.parametrize("table", list(TOKENIZERS))
def test_ids_offsets_and_decode_equal_reference(port_toks, ref_toks, table):
    port, ref = port_toks[table], ref_toks[table]
    bert = table.startswith("bert")
    for text in STRINGS + [_text("Metal_umlaut")[:2000]]:
        got = port.encode_with_offsets(text, add_special=bert)
        want = ref.encode_with_offsets(text, add_special=bert)
        assert got == want, (table, text[:40])
        assert port.decode(got[0]) == ref.decode(want[0])


def test_trained_byte_bpe_equal_reference():
    """A tokenizer.json made by the HF library (a byte-level BPE trained
    on a few sentences) loads the same in both packages."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, trainers
    tok = tokenizers.Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(STRINGS * 3, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    port, ref = from_json_str(tok.to_str()), ref_from_json_str(tok.to_str())
    for text in STRINGS + ["<|endoftext|>Hello<|endoftext|>"]:
        assert port.encode_with_offsets(text) == ref.encode_with_offsets(text)
        assert port.encode(text) == tok.encode(text).ids


# -- the native merge loop ------------------------------------------------------

def test_native_bpe_equals_python_merge_loop():
    assert native_bpe.build(), "g++ could not build native/bpe_encoder.cpp"
    native = from_json_file(DATA / "models/gpt2/tokenizer.json")
    python = from_json_file(DATA / "models/gpt2/tokenizer.json")
    assert native.impl._native_encoder() is not None
    python.impl._native = None                   # the Python merge loop
    text = _text("monty-python-credits") + _text("Metal_umlaut")
    words = python.impl._split_re.findall(text)
    enc = python.impl._byte_enc
    for word in words:
        mapped = "".join(enc[b] for b in word.encode("utf-8"))
        assert native.impl._bpe_word(mapped) == python.impl._bpe_word(mapped)
    assert native.encode(text) == python.encode(text)


# -- TextDecoder and render_chat -------------------------------------------------

def test_text_decoder_equals_reference(port_toks, ref_toks):
    for table in ("gpt2", "llama-32k"):
        for text in ("Ünïcödé † 🙂 ok", _text("Metal_umlaut")[:500]):
            ids = ref_toks[table].encode(text)
            port, ref = (TextDecoder(port_toks[table]),
                         RefTextDecoder(ref_toks[table]))
            got = [port.push(i) for i in ids] + [port.flush()]
            want = [ref.push(i) for i in ids] + [ref.flush()]
            assert got == want
            if table == "gpt2":
                # Byte-level pieces concatenate to the whole decode (a
                # Metaspace decoder strips each push's leading space).
                assert "".join(got) == ref_toks[table].decode(ids)


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_render_chat_equals_reference(template):
    msgs = [{"role": "system", "content": "S"},
            {"role": "user", "content": "Ünï\ncode"},
            {"role": "assistant", "content": ""},
            {"role": "user", "content": "again"}]
    assert render_chat(msgs, template) == ref_render_chat(msgs, template)


def test_render_chat_refusals_equal_reference():
    for bad in ([], None, [{"role": "alien", "content": "x"}],
                [{"content": "x"}]):
        for fn in (render_chat, ref_render_chat):
            with pytest.raises(ValueError):
                fn(bad)
    with pytest.raises(ValueError, match="unknown chat template"):
        render_chat([{"role": "user", "content": "x"}], "nope")
    assert render_chat([{"role": "user", "content": "x"}],
                       lambda m: "X") == "X"
