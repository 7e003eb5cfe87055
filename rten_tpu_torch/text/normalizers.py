"""Composable text normalizers with offset maps.

Every normalizer's ``normalize(text)`` returns ``(normalized, offsets)``
where ``offsets[i]`` is the index of the character in the ORIGINAL
string that produced normalized character ``i`` (the reference returns
the same normalized→original mapping at byte granularity,
rten-text/src/normalizer.rs:97-129; Python strings are char-indexed so
the map is per char). Downstream, token spans over the normalized text
map back to source-text spans — the QA-answer-extraction path
(examples/bert_qa.py) depends on this.

Covers the ``normalizer`` types that appear in real HF ``tokenizer.json``
files for the model families the framework ships loaders for:
BertNormalizer (BERT), Lowercase/NFC/NFD/NFKC/NFKD/StripAccents/Strip,
Prepend + Replace (Llama/SentencePiece style), and Sequence.
"""

from __future__ import annotations

import unicodedata


class Normalizer:
    def normalize(self, text: str) -> tuple[str, list[int]]:
        raise NotImplementedError

    @staticmethod
    def identity_map(text):
        return list(range(len(text)))


class Sequence(Normalizer):
    def __init__(self, normalizers):
        self.normalizers = list(normalizers)

    def normalize(self, text):
        offsets = Normalizer.identity_map(text)
        for n in self.normalizers:
            text, step = n.normalize(text)
            offsets = [offsets[j] for j in step]
        return text, offsets


class Lowercase(Normalizer):
    def normalize(self, text):
        out, offsets = [], []
        for i, ch in enumerate(text):
            low = ch.lower()           # may expand (e.g. İ -> i̇)
            out.append(low)
            offsets.extend([i] * len(low))
        return "".join(out), offsets


class _UnicodeForm(Normalizer):
    form = "NFC"

    def normalize(self, text):
        out, offsets = [], []
        # Normalize per source char: exact for decompositions; composing
        # sequences (rare across char boundaries) fall back to the
        # first char's offset, which is what span extraction wants.
        i = 0
        while i < len(text):
            # Greedily take a maximal run that normalizes independently:
            # a char plus any following combining marks.
            j = i + 1
            while j < len(text) and unicodedata.combining(text[j]):
                j += 1
            norm = unicodedata.normalize(self.form, text[i:j])
            out.append(norm)
            offsets.extend([i] * len(norm))
            i = j
        return "".join(out), offsets


class NFC(_UnicodeForm):
    form = "NFC"


class NFD(_UnicodeForm):
    form = "NFD"


class NFKC(_UnicodeForm):
    form = "NFKC"


class NFKD(_UnicodeForm):
    form = "NFKD"


class StripAccents(Normalizer):
    """Remove non-spacing marks (Unicode ``Mn``) after NFD decomposition
    — the reference's definition (normalizer.rs:40-49). Composed accent
    chars decompose first so ``é`` → ``e``."""

    def normalize(self, text):
        out, offsets = [], []
        for i, ch in enumerate(text):
            for d in unicodedata.normalize("NFD", ch):
                if unicodedata.category(d) != "Mn":
                    out.append(d)
                    offsets.append(i)
        return "".join(out), offsets


class Strip(Normalizer):
    def __init__(self, left=True, right=True):
        self.left, self.right = left, right

    def normalize(self, text):
        start, end = 0, len(text)
        if self.left:
            while start < end and text[start].isspace():
                start += 1
        if self.right:
            while end > start and text[end - 1].isspace():
                end -= 1
        return text[start:end], list(range(start, end))


class Prepend(Normalizer):
    """Prepend a string (Llama's ``▁``); the prepended chars map to
    original position 0."""

    def __init__(self, prepend):
        self.prepend = prepend

    def normalize(self, text):
        if not text:
            return "", []
        return (self.prepend + text,
                [0] * len(self.prepend) + Normalizer.identity_map(text))


class Replace(Normalizer):
    """Replace occurrences of ``pattern`` (literal string or regex) with
    ``content``; replacement chars map to the match's first char."""

    def __init__(self, pattern, content, is_regex=False):
        self.content = content
        if is_regex:
            import regex
            self._re = regex.compile(pattern)
        else:
            import regex
            self._re = regex.compile(regex.escape(pattern))

    def normalize(self, text):
        out, offsets = [], []
        last = 0
        for m in self._re.finditer(text):
            for i in range(last, m.start()):
                out.append(text[i])
                offsets.append(i)
            out.append(self.content)
            offsets.extend([m.start()] * len(self.content))
            last = m.end()
        for i in range(last, len(text)):
            out.append(text[i])
            offsets.append(i)
        return "".join(out), offsets


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertNormalizer(Normalizer):
    """BERT's cleanup: control-char removal, whitespace folding, CJK
    spacing, optional accent-stripping and lowercasing — the composite
    the HF ``BertNormalizer`` type performs."""

    def __init__(self, clean_text=True, handle_chinese_chars=True,
                 strip_accents=None, lowercase=True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        # HF: strip_accents=None means "strip iff lowercasing".
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        self.lowercase = lowercase

    def normalize(self, text):
        out, offsets = [], []

        def emit(s, i):
            out.append(s)
            offsets.extend([i] * len(s))

        for i, ch in enumerate(text):
            cp = ord(ch)
            if self.clean_text:
                if cp == 0 or cp == 0xFFFD or unicodedata.category(
                        ch).startswith("C") and not ch.isspace():
                    continue
                if ch.isspace() and ch != " ":
                    ch = " "
            if self.handle_chinese_chars and _is_cjk(cp):
                emit(f" {ch} ", i)
                continue
            if self.strip_accents:
                parts = [d for d in unicodedata.normalize("NFD", ch)
                         if unicodedata.category(d) != "Mn"]
                ch = "".join(parts)
                if not ch:
                    continue
            if self.lowercase:
                ch = ch.lower()
            emit(ch, i)
        return "".join(out), offsets


def from_config(cfg) -> Normalizer | None:
    """Build a normalizer from a ``tokenizer.json`` ``normalizer`` entry."""
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        return Sequence([from_config(c) for c in cfg["normalizers"]])
    if kind == "Lowercase":
        return Lowercase()
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return {"NFC": NFC, "NFD": NFD, "NFKC": NFKC,
                "NFKD": NFKD}[kind]()
    if kind == "StripAccents":
        return StripAccents()
    if kind == "Strip":
        return Strip(cfg.get("strip_left", True),
                     cfg.get("strip_right", True))
    if kind == "Prepend":
        return Prepend(cfg["prepend"])
    if kind == "Replace":
        pattern = cfg["pattern"]
        if isinstance(pattern, dict):
            if "String" in pattern:
                return Replace(pattern["String"], cfg["content"])
            if "Regex" in pattern:
                return Replace(pattern["Regex"], cfg["content"],
                               is_regex=True)
            raise ValueError(f"unsupported Replace pattern {pattern}")
        return Replace(pattern, cfg["content"])
    if kind == "BertNormalizer":
        return BertNormalizer(cfg.get("clean_text", True),
                              cfg.get("handle_chinese_chars", True),
                              cfg.get("strip_accents"),
                              cfg.get("lowercase", True))
    raise ValueError(f"unsupported normalizer type {kind!r}")
