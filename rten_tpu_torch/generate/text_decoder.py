"""Incremental UTF-8 text decoding (reference:
rten-generate/src/text_decoder.rs): tokenizers may split multi-byte
characters across tokens, so bytes are buffered until they form valid
UTF-8.

A copy of ``rten_tpu/generate/text_decoder.py`` (pure Python)."""

from __future__ import annotations


class TextDecoder:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._pending: list[int] = []

    def push(self, token_id: int) -> str:
        """Decode one more token; returns any newly-complete text."""
        self._pending.append(int(token_id))
        text = self.tokenizer.decode(self._pending)
        if text.endswith("�"):
            # Trailing replacement char: incomplete UTF-8 sequence — keep
            # buffering (but a replacement char mid-string is real output).
            return ""
        self._pending.clear()
        return text

    def flush(self) -> str:
        if not self._pending:
            return ""
        text = self.tokenizer.decode(self._pending)
        self._pending.clear()
        return text
