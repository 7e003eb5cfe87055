"""HF ``tokenizer.json`` loader + Tokenizer pipeline facade.

Reference: rten-text/src/tokenizers/json.rs + tokenizers.rs: parse the
Hugging Face tokenizer.json format and construct the matching pipeline
(normalizer → pre-tokenizer → model → post-processor, with the decoder
chain for the reverse direction), handling added/special tokens.

Beyond ids, :meth:`Tokenizer.encode_with_offsets` returns per-token
``(start, end)`` character spans into the ORIGINAL text, composed
through the normalizer's offset map (normalizers.py; the reference's
normalized→original mapping is rten-text/src/normalizer.rs:97-129) and
each pre-tokenizer piece's char map — the span-extraction contract QA
models need (examples/bert_qa.py).
"""

from __future__ import annotations

import json

from . import decoders as dec_mod
from . import normalizers as norm_mod
from . import pretokenizers as pre_mod
from .bpe import BpeTokenizer
from .wordpiece import WordPieceTokenizer


class TemplateProcessing:
    """``TemplateProcessing`` post-processor: wrap one (or a pair of)
    encoded sequences with special tokens per the template."""

    def __init__(self, single, pair, special_ids):
        self.single = single or []
        self.pair = pair or []
        self.special_ids = special_ids   # name -> [ids]

    @staticmethod
    def from_config(cfg):
        special = {name: spec["ids"]
                   for name, spec in (cfg.get("special_tokens")
                                      or {}).items()}
        return TemplateProcessing(cfg.get("single"), cfg.get("pair"),
                                  special)

    def apply(self, a, b=None):
        """``a``/``b``: [(id, span_or_None)]. Returns
        ``[(id, span, type_id)]``."""
        template = self.pair if b is not None else self.single
        out = []
        for item in template:
            if "SpecialToken" in item:
                spec = item["SpecialToken"]
                for i in self.special_ids.get(spec["id"], []):
                    out.append((i, None, spec.get("type_id", 0)))
            elif "Sequence" in item:
                seq = item["Sequence"]
                src = a if seq["id"] == "A" else (b or [])
                tid = seq.get("type_id", 0)
                out.extend((i, sp, tid) for i, sp in src)
        return out


class Tokenizer:
    """Pipeline facade with encode/decode/offsets plus chunking (the
    reference's ``encode_chunks``, tokenizers.rs:378-424)."""

    def __init__(self, impl, added_tokens=None, normalizer=None,
                 pre_tokenizer=None, decoder=None, post=None,
                 special_ids=None):
        self.impl = impl
        self.added_tokens = dict(added_tokens or {})  # token → id
        self._added_by_id = {i: t for t, i in self.added_tokens.items()}
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.decoder = decoder
        self.post = post
        # ids decode() should drop: template specials + added specials.
        self.special_ids = set(special_ids or [])

    def token_id(self, token: str):
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.impl.vocab.get(token)

    # -- encoding ------------------------------------------------------------

    def _split_added(self, text):
        """Split raw text around added/special tokens. Returns
        ``[(segment_text, seg_start)]`` interleaved with
        ``(token_id, (start, end))`` tuples (ints mark added tokens)."""
        segments = [(text, 0)]
        for token, idx in sorted(self.added_tokens.items(),
                                 key=lambda kv: -len(kv[0])):
            new_segments = []
            for seg in segments:
                if not isinstance(seg, tuple) or len(seg) != 2 \
                        or not isinstance(seg[0], str):
                    new_segments.append(seg)
                    continue
                s, off = seg
                pos = 0
                while True:
                    hit = s.find(token, pos)
                    if hit < 0:
                        if pos < len(s):
                            new_segments.append((s[pos:], off + pos))
                        break
                    if hit > pos:
                        new_segments.append((s[pos:hit], off + pos))
                    new_segments.append(
                        (idx, (off + hit, off + hit + len(token))))
                    pos = hit + len(token)
            segments = new_segments
        return segments

    def _encode_body(self, text):
        """The un-post-processed pipeline: ``[(id, span)]`` with spans
        into the original ``text`` (None for added tokens' interiors is
        never needed — added tokens carry their raw span)."""
        out = []
        first = True
        for seg in self._split_added(text):
            if isinstance(seg[0], int):
                out.append(seg)
                continue
            s, off = seg
            if self.normalizer is not None:
                norm, nmap = self.normalizer.normalize(s)
            else:
                norm, nmap = s, list(range(len(s)))
            if not norm:
                continue
            if self.pre_tokenizer is not None:
                if isinstance(self.pre_tokenizer, pre_mod.Metaspace):
                    pieces = self.pre_tokenizer.pre_tokenize(
                        norm, first_section=first)
                else:
                    pieces = self.pre_tokenizer.pre_tokenize(norm)
            else:
                pieces = [(norm, list(range(len(norm))))]
            first = False
            for piece, pmap in pieces:
                for idx, (cs, ce) in self.impl.encode_piece(piece):
                    if pmap and ce > cs:
                        start = nmap[pmap[cs]] + off
                        end = nmap[pmap[ce - 1]] + 1 + off
                    else:
                        start = end = off
                    out.append((idx, (start, end)))
        return out

    def encode(self, text: str, add_special=False) -> list[int]:
        return [i for i, _ in self.encode_full(text, add_special)]

    def encode_with_offsets(self, text: str, add_special=False):
        """Returns ``(ids, offsets)``; ``offsets[i]`` is the token's
        ``(start, end)`` char span in ``text`` (``None`` for template
        special tokens)."""
        pairs = self.encode_full(text, add_special)
        return [i for i, _ in pairs], [sp for _, sp in pairs]

    def encode_full(self, text: str, add_special=False):
        body = self._encode_body(text)
        if add_special:
            if self.post is not None:
                return [(i, sp) for i, sp, _ in self.post.apply(body)]
            # Legacy WordPiece behavior: bracket with [CLS]/[SEP].
            vocab = self.impl.vocab
            if "[CLS]" in vocab and "[SEP]" in vocab:
                return ([(vocab["[CLS]"], None)] + body
                        + [(vocab["[SEP]"], None)])
        return body

    def encode_pair(self, a: str, b: str):
        """Encode a sequence pair through the post-processor (QA-style
        question+context). Returns ``(ids, type_ids, offsets)`` where
        offsets of sequence-A tokens and specials are ``None`` and
        sequence-B tokens carry spans into ``b``."""
        ea = [(i, None) for i, _ in self._encode_body(a)]
        eb = self._encode_body(b)
        if self.post is not None:
            trip = self.post.apply(ea, eb)
        else:
            vocab = self.impl.vocab
            trip = []
            if "[CLS]" in vocab:
                trip.append((vocab["[CLS]"], None, 0))
            trip += [(i, sp, 0) for i, sp in ea]
            if "[SEP]" in vocab:
                trip.append((vocab["[SEP]"], None, 0))
            trip += [(i, sp, 1) for i, sp in eb]
            if "[SEP]" in vocab:
                trip.append((vocab["[SEP]"], None, 1))
        return ([i for i, _, _ in trip], [t for _, _, t in trip],
                [sp for _, sp, _ in trip])

    # -- decoding ------------------------------------------------------------

    def decode(self, ids) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i in self.special_ids:
                continue
            if i in self._added_by_id:
                toks.append(self._added_by_id[i])
            else:
                t = self.impl.id_to_token.get(i)
                if t is not None:
                    toks.append(t)
        if self.decoder is not None:
            return self.decoder.decode(toks)
        return self.impl.decode([self.impl.vocab[t] for t in toks
                                 if t in self.impl.vocab])

    def encode_chunks(self, text: str, max_len: int, overlap: int = 0):
        """Encode then split into chunks of ``max_len`` with ``overlap``."""
        ids = self.encode(text)
        if max_len <= overlap:
            raise ValueError("max_len must exceed overlap")
        step = max_len - overlap
        return [ids[i:i + max_len]
                for i in range(0, max(len(ids) - overlap, 1), step)]


def from_json_str(data: str) -> Tokenizer:
    spec = json.loads(data)
    model = spec.get("model", {})
    model_type = model.get("type")
    added = {}
    special_added = set()
    for tok in spec.get("added_tokens", []):
        added[tok["content"]] = int(tok["id"])
        if tok.get("special"):
            special_added.add(int(tok["id"]))

    normalizer = norm_mod.from_config(spec.get("normalizer"))
    pre_tokenizer = pre_mod.from_config(spec.get("pre_tokenizer"))
    decoder = dec_mod.from_config(spec.get("decoder"))

    post = None
    post_cfg = spec.get("post_processor") or {}
    special_ids = set(special_added)
    if post_cfg.get("type") == "TemplateProcessing":
        post = TemplateProcessing.from_config(post_cfg)
        for ids in post.special_ids.values():
            special_ids.update(ids)
    elif post_cfg.get("type") in ("BertProcessing", "RobertaProcessing"):
        sep, cls = post_cfg["sep"], post_cfg["cls"]
        post = TemplateProcessing(
            single=[{"SpecialToken": {"id": "cls", "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}},
                    {"SpecialToken": {"id": "sep", "type_id": 0}}],
            pair=[{"SpecialToken": {"id": "cls", "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "sep", "type_id": 0}},
                  {"Sequence": {"id": "B", "type_id": 1}},
                  {"SpecialToken": {"id": "sep", "type_id": 1}}],
            special_ids={"cls": [cls[1]], "sep": [sep[1]]})
        special_ids.update([cls[1], sep[1]])
    # "ByteLevel"/"Sequence-of-ByteLevel" post-processors only affect
    # offset trimming, which encode_full already reports exactly.

    if model_type == "BPE":
        merges = []
        for m in model.get("merges", []):
            if isinstance(m, str):
                a, _, b = m.partition(" ")
                merges.append((a, b))
            else:
                merges.append((m[0], m[1]))
        byte_level = isinstance(pre_tokenizer, pre_mod.ByteLevel) or (
            isinstance(pre_tokenizer, pre_mod.Sequence)
            and any(isinstance(p, pre_mod.ByteLevel)
                    for p in pre_tokenizer.pretokenizers))
        impl = BpeTokenizer(
            vocab=model["vocab"], merges=merges,
            special_tokens=added,
            end_of_word_suffix=model.get("end_of_word_suffix") or "",
            byte_level=byte_level,
            unk_token=model.get("unk_token"),
            byte_fallback=bool(model.get("byte_fallback")),
            fuse_unk=bool(model.get("fuse_unk")),
            ignore_merges=bool(model.get("ignore_merges")),
            continuing_subword_prefix=model.get(
                "continuing_subword_prefix"))
        if decoder is None and byte_level:
            decoder = dec_mod.ByteLevel()
    elif model_type == "WordPiece":
        norm_cfg = spec.get("normalizer") or {}
        impl = WordPieceTokenizer(
            vocab=model["vocab"],
            lowercase=bool(norm_cfg.get("lowercase", True)),
            strip_accents=norm_cfg.get("strip_accents"),
            unk_token=model.get("unk_token", "[UNK]"),
            continuing_prefix=model.get("continuing_subword_prefix",
                                        "##"),
            max_word_chars=model.get("max_input_chars_per_word", 100))
        if normalizer is None:
            # A WordPiece model without an explicit normalizer entry
            # still lowercases per its legacy flags.
            normalizer = norm_mod.BertNormalizer(
                clean_text=True, handle_chinese_chars=True,
                strip_accents=norm_cfg.get("strip_accents"),
                lowercase=bool(norm_cfg.get("lowercase", True)))
        if pre_tokenizer is None:
            pre_tokenizer = pre_mod.BertPreTokenizer()
        if decoder is None:
            decoder = dec_mod.WordPiece(
                model.get("continuing_subword_prefix", "##"))
    else:
        raise ValueError(f"unsupported tokenizer model type {model_type!r}")
    return Tokenizer(impl, added, normalizer=normalizer,
                     pre_tokenizer=pre_tokenizer, decoder=decoder,
                     post=post, special_ids=special_ids)


def from_json_file(path) -> Tokenizer:
    with open(path, encoding="utf-8") as f:
        return from_json_str(f.read())


def wordpiece_from_vocab(path, lowercase=True) -> Tokenizer:
    """Build a BERT-style tokenizer from a bare ``vocab.txt`` (one token
    per line, id = line number) — the reference's ``from_vocab``
    constructor for models shipped without a ``tokenizer.json``."""
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    impl = WordPieceTokenizer(vocab, lowercase=lowercase)
    special_ids = {vocab[t] for t in ("[CLS]", "[SEP]", "[PAD]")
                   if t in vocab}
    return Tokenizer(
        impl,
        normalizer=norm_mod.BertNormalizer(lowercase=lowercase),
        pre_tokenizer=pre_mod.BertPreTokenizer(),
        decoder=dec_mod.WordPiece(),
        special_ids=special_ids)
