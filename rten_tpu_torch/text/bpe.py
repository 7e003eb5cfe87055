"""Byte-level BPE (GPT-2 style).

Reference: rten-text/src/tokenizers/bpe.rs. Encoding: pre-tokenize with
the GPT-2 regex, map bytes through the printable-unicode byte encoder,
then greedily apply merges by rank.
"""

from __future__ import annotations

import functools


def bytes_to_unicode():
    """GPT-2's reversible byte↔unicode table: printable chars map to
    themselves, the rest shift into the U+0100.. range."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
               r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class BpeTokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: dict[str, int] | None = None,
                 end_of_word_suffix: str = "", split_pattern=None,
                 byte_level: bool = True, unk_token: str | None = None,
                 byte_fallback: bool = False, fuse_unk: bool = False,
                 ignore_merges: bool = False,
                 continuing_subword_prefix: str = ""):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merge_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        for tok, idx in self.special_tokens.items():
            self.id_to_token.setdefault(idx, tok)
        self.end_of_word_suffix = end_of_word_suffix
        self.byte_level = byte_level
        self.unk_token = unk_token
        self.byte_fallback = byte_fallback
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.continuing_subword_prefix = continuing_subword_prefix or ""
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        import regex
        self._split_re = regex.compile(split_pattern or _GPT2_SPLIT)

    def _native_encoder(self):
        """Lazily build the C++ merge-loop encoder (native/bpe_encoder.cpp)
        with string→id interning; None if the library isn't available."""
        if hasattr(self, "_native"):
            return self._native
        self._native = None
        try:
            from . import native_bpe
            self._native = native_bpe.NativeBpe(self.merge_ranks)
        except Exception:
            pass
        return self._native

    @functools.lru_cache(maxsize=65536)
    def _bpe_word(self, word: str) -> tuple[str, ...]:
        parts = list(word)
        prefix = self.continuing_subword_prefix
        if prefix:
            # HF semantics (tokenizers BPE model): every non-initial
            # character carries the prefix, and a merge's output is
            # ``left + right[len(prefix):]`` — so merged continuation
            # tokens keep exactly one leading prefix.
            parts = parts[:1] + [prefix + c for c in parts[1:]]
        if self.end_of_word_suffix and parts:
            parts[-1] += self.end_of_word_suffix
        if len(parts) == 1:
            return tuple(parts)
        native = None if prefix else self._native_encoder()
        if native is not None:
            return native.apply(parts)
        plen = len(prefix)
        while True:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                rank = self.merge_ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                return tuple(parts)
            right = parts[best_i + 1]
            if plen and right.startswith(prefix):
                right = right[plen:]
            parts[best_i:best_i + 2] = [parts[best_i] + right]

    def encode(self, text: str, add_special=False) -> list[int]:
        ids: list[int] = []
        for piece in self._split_re.findall(text):
            if self.byte_level:
                piece = "".join(self._byte_enc[b]
                                for b in piece.encode("utf-8"))
            for token in self._bpe_word(piece):
                idx = self.vocab.get(token)
                if idx is not None:
                    ids.append(idx)
        return ids

    def _tok_len(self, token: str, is_last: bool,
                 is_first: bool = True) -> int:
        """Length of a merge-output token in model-input chars: the
        end-of-word suffix on the last token and the continuing-subword
        prefix on non-first tokens are synthetic."""
        n = len(token)
        if is_last and self.end_of_word_suffix:
            n -= len(self.end_of_word_suffix)
        if (not is_first and self.continuing_subword_prefix
                and token.startswith(self.continuing_subword_prefix)):
            n -= len(self.continuing_subword_prefix)
        return n

    def encode_piece(self, piece: str):
        """Encode ONE pre-tokenized piece; returns
        ``[(id, (start, end))]`` with char ranges into ``piece``.

        Handles the model-level ``tokenizer.json`` options: byte-level
        input encoding (ranges then cover the chars whose UTF-8 bytes a
        token spans), ``ignore_merges`` (whole-piece vocab hit short-
        circuits, Llama-3), ``byte_fallback`` (OOV merge outputs emit
        ``<0xNN>`` byte tokens, SentencePiece style), ``unk_token`` +
        ``fuse_unk``. OOV without fallback or unk is dropped (HF
        behavior)."""
        if not piece:
            return []
        if self.byte_level:
            enc = []
            char_of = []          # char index owning each encoded char
            for ci, ch in enumerate(piece):
                bs = ch.encode("utf-8")
                enc.append("".join(self._byte_enc[b] for b in bs))
                char_of.extend([ci] * len(bs))
            enc = "".join(enc)
        else:
            enc = piece
            char_of = list(range(len(piece)))

        if self.ignore_merges and enc in self.vocab:
            return [(self.vocab[enc], (0, len(piece)))]

        out = []
        pos = 0               # position in enc chars
        unk = self.vocab.get(self.unk_token) \
            if self.unk_token is not None else None
        tokens = self._bpe_word(enc)
        for ti, token in enumerate(tokens):
            n = self._tok_len(token, ti == len(tokens) - 1, ti == 0)
            span = (char_of[pos], char_of[pos + n - 1] + 1) if n else \
                (char_of[min(pos, len(char_of) - 1)],) * 2
            idx = self.vocab.get(token)
            if idx is not None:
                out.append((idx, span))
            elif self.byte_fallback:
                raw = token
                if (ti and self.continuing_subword_prefix
                        and raw.startswith(self.continuing_subword_prefix)):
                    raw = raw[len(self.continuing_subword_prefix):]
                raw = raw[:n] if n != len(raw) else raw
                ok = True
                btoks = []
                for b in raw.encode("utf-8"):
                    bid = self.vocab.get(f"<0x{b:02X}>")
                    if bid is None:
                        ok = False
                        break
                    btoks.append(bid)
                if ok:
                    out.extend((bid, span) for bid in btoks)
                elif unk is not None:
                    out.append((unk, span))
            elif unk is not None:
                if not (self.fuse_unk and out and out[-1][0] == unk):
                    out.append((unk, span))
                elif out:
                    # Fuse: widen the previous unk's span.
                    out[-1] = (unk, (out[-1][1][0], span[1]))
            pos += n
        return out

    def decode(self, ids) -> str:
        text = "".join(self.id_to_token.get(int(i), "") for i in ids)
        if self.byte_level:
            data = bytes(self._byte_dec[c] for c in text
                         if c in self._byte_dec)
            return data.decode("utf-8", errors="replace")
        if self.end_of_word_suffix:
            return text.replace(self.end_of_word_suffix, " ").rstrip()
        return text
