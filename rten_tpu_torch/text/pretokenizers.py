"""Pre-tokenizers: split normalized text into model-input pieces.

``pre_tokenize(text)`` returns ``[(piece, offmap)]`` where ``offmap[k]``
is the index in ``text`` of the character that produced piece char
``k``. Pieces may differ from the spanned text (Metaspace rewrites
spaces to ``▁``; an added prefix char maps to the following char's
index), so an explicit per-char map — composed with the normalizer's
map (normalizers.py) — keeps token→source-text offsets exact end to
end.

Covers the ``pre_tokenizer`` types in real HF ``tokenizer.json`` files
for the supported families: ByteLevel (GPT-2/Llama-3), Metaspace
(SentencePiece-style Llama/Mistral), BertPreTokenizer, Whitespace,
WhitespaceSplit, Split (regex, all five behaviors), Punctuation,
Digits, and Sequence. Reference behavior: rten-text/src/split.rs +
tokenizers/json.rs.
"""

from __future__ import annotations

import unicodedata

GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
              r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _ident(start, n):
    return list(range(start, start + n))


class PreTokenizer:
    def pre_tokenize(self, text):
        raise NotImplementedError

    def _resplit(self, pieces, fn):
        """Apply ``fn`` (a text → [(piece, offmap)] splitter) to each
        existing piece, composing offmaps."""
        out = []
        for piece, offmap in pieces:
            for sub, submap in fn(piece):
                out.append((sub, [offmap[j] for j in submap]))
        return out


class Sequence(PreTokenizer):
    def __init__(self, pretokenizers):
        self.pretokenizers = list(pretokenizers)

    def pre_tokenize(self, text):
        pieces = [(text, _ident(0, len(text)))]
        for p in self.pretokenizers:
            pieces = self._resplit(pieces, p.pre_tokenize)
        return pieces


class Whitespace(PreTokenizer):
    """HF ``Whitespace``: runs of word chars or runs of non-space
    punctuation (regex ``\\w+|[^\\w\\s]+``); whitespace is dropped."""

    def __init__(self):
        import regex
        self._re = regex.compile(r"\w+|[^\w\s]+")

    def pre_tokenize(self, text):
        return [(m.group(), _ident(m.start(), len(m.group())))
                for m in self._re.finditer(text)]


class WhitespaceSplit(PreTokenizer):
    def pre_tokenize(self, text):
        out, start = [], None
        for i, ch in enumerate(text):
            if ch.isspace():
                if start is not None:
                    out.append((text[start:i], _ident(start, i - start)))
                    start = None
            elif start is None:
                start = i
        if start is not None:
            out.append((text[start:], _ident(start, len(text) - start)))
        return out


def _is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BertPreTokenizer(PreTokenizer):
    """Whitespace split, then isolate each punctuation char."""

    def pre_tokenize(self, text):
        words = WhitespaceSplit().pre_tokenize(text)
        out = []
        for piece, offmap in words:
            start = 0
            for i, ch in enumerate(piece):
                if _is_punct(ch):
                    if start < i:
                        out.append((piece[start:i], offmap[start:i]))
                    out.append((ch, offmap[i:i + 1]))
                    start = i + 1
            if start < len(piece):
                out.append((piece[start:], offmap[start:]))
        return out


class Punctuation(PreTokenizer):
    def __init__(self, behavior="Isolated"):
        self.behavior = behavior

    def pre_tokenize(self, text):
        spans = [(m, m + 1) for m, ch in enumerate(text) if _is_punct(ch)]
        return _apply_behavior(text, spans, self.behavior)


class Digits(PreTokenizer):
    def __init__(self, individual_digits=False):
        self.individual_digits = individual_digits

    def pre_tokenize(self, text):
        import regex
        pat = r"\p{N}" if self.individual_digits else r"\p{N}+"
        spans = [(m.start(), m.end())
                 for m in regex.finditer(pat, text)]
        return _apply_behavior(text, spans, "Isolated")


def _apply_behavior(text, match_spans, behavior):
    """Split ``text`` around ``match_spans`` per the HF ``SplitDelimiter
    Behavior``: Removed, Isolated, MergedWithPrevious, MergedWithNext,
    Contiguous."""
    pieces = []          # (start, end, is_match)
    last = 0
    for s, e in match_spans:
        if s > last:
            pieces.append((last, s, False))
        pieces.append((s, e, True))
        last = e
    if last < len(text):
        pieces.append((last, len(text), False))

    out = []
    if behavior == "Removed":
        out = [(s, e) for s, e, m in pieces if not m]
    elif behavior == "Isolated":
        out = [(s, e) for s, e, m in pieces]
    elif behavior == "MergedWithPrevious":
        for s, e, m in pieces:
            if m and out:
                ps, _ = out.pop()
                out.append((ps, e))
            else:
                out.append((s, e))
    elif behavior == "MergedWithNext":
        pending = None
        for s, e, m in pieces:
            if m:
                pending = s if pending is None else pending
            else:
                out.append((pending if pending is not None else s, e))
                pending = None
        if pending is not None:
            out.append((pending, len(text)))
    elif behavior == "Contiguous":
        for s, e, m in pieces:
            if out and out[-1][2] == m:
                ps, _, _ = out.pop()
                out.append((ps, e, m))
            else:
                out.append((s, e, m))
        out = [(s, e) for s, e, _ in out]
    else:
        raise ValueError(f"unsupported split behavior {behavior!r}")
    return [(text[s:e], _ident(s, e - s)) for s, e in out if e > s]


class Split(PreTokenizer):
    def __init__(self, pattern, behavior="Isolated", invert=False):
        import regex
        if isinstance(pattern, dict):
            if "Regex" in pattern:
                pattern = pattern["Regex"]
            else:
                pattern = regex.escape(pattern["String"])
        else:
            pattern = regex.escape(pattern)
        self._re = regex.compile(pattern)
        self.behavior = behavior
        self.invert = invert

    def pre_tokenize(self, text):
        spans = [(m.start(), m.end()) for m in self._re.finditer(text)
                 if m.end() > m.start()]
        if self.invert:
            # Matches become the KEPT pieces; gaps are the delimiters.
            inv, last = [], 0
            for s, e in spans:
                if s > last:
                    inv.append((last, s))
                last = e
            if last < len(text):
                inv.append((last, len(text)))
            spans = inv
        return _apply_behavior(text, spans, self.behavior)


class ByteLevel(PreTokenizer):
    """GPT-2 style: optional prefix space + regex word split. Pieces
    stay RAW here (the byte→printable-unicode encoding happens in the
    BPE model stage, which needs the raw piece for offsets)."""

    def __init__(self, add_prefix_space=True, use_regex=True):
        self.add_prefix_space = add_prefix_space
        import regex
        self._re = regex.compile(GPT2_SPLIT) if use_regex else None

    def pre_tokenize(self, text):
        offmap = _ident(0, len(text))
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
            offmap = [0] + offmap
        if self._re is None:
            return [(text, offmap)] if text else []
        return [(m.group(), offmap[m.start():m.end()])
                for m in self._re.finditer(text)]


class Metaspace(PreTokenizer):
    """SentencePiece-style: rewrite spaces to ``replacement`` (``▁``),
    optionally prepend one, split keeping the replacement glued to the
    FOLLOWING word (``MergedWithNext``)."""

    def __init__(self, replacement="▁", prepend_scheme="always",
                 split=True):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme   # always | first | never
        self.split = split

    def pre_tokenize(self, text, first_section=True):
        offmap = _ident(0, len(text))
        prepend = (self.prepend_scheme == "always"
                   or (self.prepend_scheme == "first" and first_section))
        if prepend and text and not text.startswith(self.replacement) \
                and not text.startswith(" "):
            text = " " + text
            offmap = [0] + offmap
        text = text.replace(" ", self.replacement)
        if not self.split:
            return [(text, offmap)] if text else []
        out, start = [], 0
        for i, ch in enumerate(text):
            if ch == self.replacement and i > start:
                out.append((text[start:i], offmap[start:i]))
                start = i
        if start < len(text):
            out.append((text[start:], offmap[start:]))
        return out


def from_config(cfg) -> PreTokenizer | None:
    """Build from a ``tokenizer.json`` ``pre_tokenizer`` entry."""
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        return Sequence([from_config(c) for c in cfg["pretokenizers"]])
    if kind == "ByteLevel":
        return ByteLevel(cfg.get("add_prefix_space", True),
                         cfg.get("use_regex", True))
    if kind == "Metaspace":
        scheme = cfg.get("prepend_scheme")
        if scheme is None:
            # Legacy field: add_prefix_space=True ≙ "always".
            scheme = "always" if cfg.get("add_prefix_space", True) \
                else "never"
        return Metaspace(cfg.get("replacement", "▁"), scheme,
                         cfg.get("split", True))
    if kind == "BertPreTokenizer":
        return BertPreTokenizer()
    if kind == "Whitespace":
        return Whitespace()
    if kind == "WhitespaceSplit":
        return WhitespaceSplit()
    if kind == "Split":
        return Split(cfg["pattern"], cfg.get("behavior", "Isolated"),
                     cfg.get("invert", False))
    if kind == "Punctuation":
        return Punctuation(cfg.get("behavior", "Isolated"))
    if kind == "Digits":
        return Digits(cfg.get("individual_digits", False))
    raise ValueError(f"unsupported pre_tokenizer type {kind!r}")
