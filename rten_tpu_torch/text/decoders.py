"""Token→text decoders (the inverse pipeline stage).

Mirrors the ``decoder`` entry of HF ``tokenizer.json``: a decoder maps
the token STRINGS back to text (ByteLevel reverses the byte encoding,
Metaspace/Replace rewrite ``▁``, ByteFallback re-assembles ``<0xNN>``
runs, WordPiece strips ``##``...). Reference behavior:
rten-text/src/tokenizers/bpe.rs (byte decoding) + json.rs.
"""

from __future__ import annotations


class Decoder:
    def decode(self, tokens: list[str]) -> str:
        return "".join(self.decode_chain(tokens))

    def decode_chain(self, tokens: list[str]) -> list[str]:
        raise NotImplementedError


class Sequence(Decoder):
    def __init__(self, decoders):
        self.decoders = list(decoders)

    def decode_chain(self, tokens):
        for d in self.decoders:
            tokens = d.decode_chain(tokens)
        return tokens


class ByteLevel(Decoder):
    def __init__(self):
        from .bpe import bytes_to_unicode
        self._dec = {v: k for k, v in bytes_to_unicode().items()}

    def decode_chain(self, tokens):
        data = bytes(self._dec[c] for t in tokens for c in t
                     if c in self._dec)
        return [data.decode("utf-8", errors="replace")]


class Replace(Decoder):
    def __init__(self, pattern, content):
        if isinstance(pattern, dict):
            pattern = pattern.get("String", pattern.get("Regex"))
        self.pattern, self.content = pattern, content

    def decode_chain(self, tokens):
        return [t.replace(self.pattern, self.content) for t in tokens]


class Metaspace(Decoder):
    def __init__(self, replacement="▁", prepend_scheme="always"):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme

    def decode_chain(self, tokens):
        out = []
        for i, t in enumerate(tokens):
            t = t.replace(self.replacement, " ")
            if i == 0 and t.startswith(" ") \
                    and self.prepend_scheme != "never":
                t = t[1:]
            out.append(t)
        return out


class ByteFallback(Decoder):
    """Runs of ``<0xNN>`` tokens decode as UTF-8 byte sequences."""

    def decode_chain(self, tokens):
        out, pending = [], []

        def flush():
            if pending:
                out.append(bytes(pending).decode("utf-8",
                                                 errors="replace"))
                pending.clear()

        for t in tokens:
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    pending.append(int(t[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(t)
        flush()
        return out


class Fuse(Decoder):
    def decode_chain(self, tokens):
        return ["".join(tokens)]


class Strip(Decoder):
    def __init__(self, content=" ", start=0, stop=0):
        self.content, self.start, self.stop = content, start, stop

    def decode_chain(self, tokens):
        out = []
        for t in tokens:
            n = 0
            while n < self.start and t.startswith(self.content, n):
                n += 1
            m = len(t)
            stops = 0
            while stops < self.stop and m > n \
                    and t.endswith(self.content, n, m):
                m -= 1
                stops += 1
            out.append(t[n:m])
        return out


class WordPiece(Decoder):
    def __init__(self, prefix="##", cleanup=True):
        self.prefix, self.cleanup = prefix, cleanup

    def decode_chain(self, tokens):
        out = []
        for i, t in enumerate(tokens):
            if i and t.startswith(self.prefix):
                out.append(t[len(self.prefix):])
            elif i:
                out.append(" " + t)
            else:
                out.append(t)
        text = "".join(out)
        if self.cleanup:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"),
                         (" ,", ","), (" ' ", "' "), (" n't", "n't"),
                         (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return [text]


class BPEDecoder(Decoder):
    def __init__(self, suffix="</w>"):
        self.suffix = suffix

    def decode_chain(self, tokens):
        return [t.replace(self.suffix, " ") for t in tokens]


def from_config(cfg) -> Decoder | None:
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        return Sequence([from_config(c) for c in cfg["decoders"]])
    if kind == "ByteLevel":
        return ByteLevel()
    if kind == "Replace":
        return Replace(cfg["pattern"], cfg["content"])
    if kind == "Metaspace":
        scheme = cfg.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if cfg.get("add_prefix_space", True) \
                else "never"
        return Metaspace(cfg.get("replacement", "▁"), scheme)
    if kind == "ByteFallback":
        return ByteFallback()
    if kind == "Fuse":
        return Fuse()
    if kind == "Strip":
        return Strip(cfg.get("content", " "), cfg.get("start", 0),
                     cfg.get("stop", 0))
    if kind == "WordPiece":
        return WordPiece(cfg.get("prefix", "##"),
                         cfg.get("cleanup", True))
    if kind == "BPEDecoder":
        return BPEDecoder(cfg.get("suffix", "</w>"))
    raise ValueError(f"unsupported decoder type {kind!r}")
