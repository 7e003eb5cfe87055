"""Tokenizers — pure-Python analog of the reference's rten-text crate:
the HF ``tokenizer.json`` pipeline (normalizers with offset maps,
pre-tokenizers incl. ByteLevel/Metaspace, byte-level + byte-fallback
BPE, WordPiece, decoders, template post-processing). Validated against
the HF ``tokenizers`` library and real-corpus goldens in tests (the
reference validates against the same corpus,
rten-text/test-data/reftests; offset mapping per
rten-text/src/normalizer.rs:97-129).

A copy of ``rten_tpu/text`` (pure Python; ``regex`` is imported lazily by
the BPE model and the regex pre-tokenizers); the native merge loop builds
into ``rten_tpu_torch/build/native/`` (:mod:`.native_bpe`)."""

from .bpe import BpeTokenizer
from .wordpiece import WordPieceTokenizer
from .tokenizer import (Tokenizer, from_json_file, from_json_str,
                        wordpiece_from_vocab)

__all__ = ["BpeTokenizer", "WordPieceTokenizer", "Tokenizer",
           "from_json_file", "from_json_str", "wordpiece_from_vocab"]
