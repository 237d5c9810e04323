"""CLIP byte-level BPE tokenizer (counterpart of ``open_clip_tpu/tokenizer.py``).

Only the standard library: the pre-tokenisation pattern needs the Unicode
letter and number classes ``\\p{L}`` and ``\\p{N}``, which stdlib ``re`` lacks, so
they are built here from ``unicodedata`` categories (``[^\\W\\d_]`` would wrongly
take category-No characters such as ``²`` and ``½`` as letters). They follow the
Unicode version of the interpreter's ``unicodedata``; ``regex`` may follow a newer
one, so code points assigned only there can split differently. Without
``ftfy``, ``basic_clean`` is ``html.unescape`` twice and a strip, as the JAX
package's fallback is. Outputs are numpy int32 arrays.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import sys
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

DEFAULT_CONTEXT_LENGTH = 77

_VOCAB_PATH = Path(__file__).parent / "assets_bpe_vocab_16e6.txt.gz"


@functools.lru_cache(maxsize=None)
def unicode_class(prefix: str) -> str:
    """The body of a regex character class holding every code point whose Unicode
    general category starts with ``prefix`` ("L": letters, "N": numbers)."""
    parts, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append(f"\\U{start:08x}-\\U{prev:08x}" if prev > start else f"\\U{start:08x}")
            start = None
    if start is not None:
        parts.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(parts)


@functools.lru_cache()
def byte_to_unicode_table() -> Dict[int, str]:
    """Reversible byte <-> printable-unicode mapping of byte-level BPE."""
    visible = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
               + list(range(ord("®"), ord("ÿ") + 1)))
    chars = visible[:]
    offset = 0
    for b in range(256):
        if b not in visible:
            visible.append(b)
            chars.append(256 + offset)
            offset += 1
    return dict(zip(visible, (chr(c) for c in chars)))


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


# the clean functions the model configs name ("lower" is CLIP's)
_CLEAN_FNS = {
    "lower": lambda x: whitespace_clean(basic_clean(x)).lower(),
    "whitespace": lambda x: whitespace_clean(basic_clean(x)),
}


class SimpleTokenizer:
    """OpenAI CLIP BPE tokenizer. vocab_size 49408, sot 49406, eot 49407."""

    def __init__(self, context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH, clean: str = "lower"):
        self.byte_encoder = byte_to_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(_VOCAB_PATH, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # line 0 is a header; CLIP uses the first 48894 merges (49152 - 256 - 2)
        merges = [tuple(line.split()) for line in lines[1: 49152 - 256 - 2 + 1]]
        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base] + ["".join(m) for m in merges]
        specials = ["<start_of_text>", "<end_of_text>"]
        vocab += specials
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank: Dict[tuple, int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {t: t for t in specials}
        letters, numbers = unicode_class("L"), unicode_class("N")
        # The reference compiles the whole pattern with IGNORECASE; the classes here
        # are case-sensitive because stdlib re would also let U+0345 (category Mn,
        # upper case U+0399) match the letter class. Under the reference pattern that
        # code point matches no alternative, so it is kept out of the last class too.
        self.token_pattern = re.compile(
            "(?i:" + "|".join(specials) + r"|'s|'t|'re|'ve|'m|'ll|'d)"
            + rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}\u0345]+")
        self.vocab_size = len(self.encoder)
        self.sot_token_id, self.eot_token_id = (self.encoder[t] for t in specials)
        self.context_length = context_length
        if clean not in _CLEAN_FNS:
            raise ValueError(f"invalid clean function {clean!r}")
        self.clean_fn = _CLEAN_FNS[clean]

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        result = " ".join(parts)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self.token_pattern.findall(self.clean_fn(text)):
            token_uni = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(token_uni).split(" "))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, List[str]], context_length: Optional[int] = None) -> np.ndarray:
        """(N, context_length) int32 ids; overlong inputs are truncated with the EOT
        token forced into the last slot."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        if not context_length:
            raise ValueError("context length required")
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


@functools.lru_cache(maxsize=1)
def _default() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts, context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    return _default()(texts, context_length=context_length)
