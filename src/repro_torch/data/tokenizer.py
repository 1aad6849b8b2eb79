"""Byte-level tokenizer (port of `repro/data/tokenizer.py`; needs no
vocab file).

UTF-8 bytes offset past three special tokens.  `chip_smoke.py` writes
its training token file with it; the data pipeline needs only encode,
decode and vocab_size, so a BPE tokenizer could take its place.
"""
from __future__ import annotations

PAD, BOS, EOS = 0, 1, 2
SPECIALS = 3


class ByteTokenizer:
    vocab_size = 256 + SPECIALS

    def encode(self, text: str, bos: bool = True, eos: bool = False):
        ids = [b + SPECIALS for b in text.encode("utf-8")]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        data = bytes(i - SPECIALS for i in ids if i >= SPECIALS)
        return data.decode("utf-8", errors="replace")
