"""WordPiece tokenizer (BERT family).

Reference: rten-text/src/tokenizers/wordpiece.rs: greedy longest-match
subwords with the ``##`` continuation prefix, after BERT normalization
(lowercase + accent stripping + punctuation/CJK splitting).
"""

from __future__ import annotations

import unicodedata


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], lowercase=True,
                 strip_accents=None, unk_token="[UNK]",
                 continuing_prefix="##", max_word_chars=100):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        self.unk_token = unk_token
        self.continuing_prefix = continuing_prefix
        self.max_word_chars = max_word_chars

    def _basic_tokenize(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: list[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif _is_punctuation(ch) or _is_cjk(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def encode(self, text: str, add_special=False) -> list[int]:
        ids: list[int] = []
        if add_special and "[CLS]" in self.vocab:
            ids.append(self.vocab["[CLS]"])
        unk = self.vocab.get(self.unk_token)
        for word in self._basic_tokenize(text):
            if len(word) > self.max_word_chars:
                if unk is not None:
                    ids.append(unk)
                continue
            start = 0
            pieces: list[int] = []
            ok = True
            while start < len(word):
                end = len(word)
                match = None
                while end > start:
                    piece = word[start:end]
                    if start > 0:
                        piece = self.continuing_prefix + piece
                    if piece in self.vocab:
                        match = self.vocab[piece]
                        break
                    end -= 1
                if match is None:
                    ok = False
                    break
                pieces.append(match)
                start = end
            if ok:
                ids.extend(pieces)
            elif unk is not None:
                ids.append(unk)
        if add_special and "[SEP]" in self.vocab:
            ids.append(self.vocab["[SEP]"])
        return ids

    def encode_piece(self, piece: str):
        """Encode ONE already-normalized, pre-tokenized word; returns
        ``[(id, (start, end))]`` with char ranges into ``piece`` (greedy
        longest-match; whole word becomes ``unk`` on any failure, with
        the full span)."""
        if not piece:
            return []
        unk = self.vocab.get(self.unk_token)
        full = [(unk, (0, len(piece)))] if unk is not None else []
        if len(piece) > self.max_word_chars:
            return full
        out = []
        start = 0
        while start < len(piece):
            end = len(piece)
            match = None
            while end > start:
                sub = piece[start:end]
                if start > 0:
                    sub = self.continuing_prefix + sub
                if sub in self.vocab:
                    match = self.vocab[sub]
                    break
                end -= 1
            if match is None:
                return full
            out.append((match, (start, end)))
            start = end
        return out

    def decode(self, ids) -> str:
        out: list[str] = []
        for i in ids:
            token = self.id_to_token.get(int(i), "")
            if token in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if token.startswith(self.continuing_prefix):
                out.append(token[len(self.continuing_prefix):])
            else:
                if out:
                    out.append(" ")
                out.append(token)
        return "".join(out)
