"""Byte-level tokenizer (no external vocab files — fully offline; a copy of
the reference's ``repro.data.tokenizer``)."""
from __future__ import annotations


__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """ids 0..255 = bytes; 256 = BOS; 257 = EOS; 258 = PAD."""

    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, add_special: bool = True):
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids + [self.EOS]) if add_special else ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")
