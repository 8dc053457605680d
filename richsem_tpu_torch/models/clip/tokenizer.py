"""Byte-level BPE tokenizer for CLIP text (a copy of
``richsem_tpu/models/clip/tokenizer.py``, plain Python, so that the port
imports nothing of the JAX package).

``SimpleTokenizer`` is the reference's (``clip/simple_tokenizer.py:62-132``):
byte-to-unicode mapping and merge-ranked BPE over CLIP's vocabulary
(``bpe_simple_vocab_16e6.txt.gz``, supplied by the user), with ftfy replaced
by NFC normalization and whitespace collapsing and the ``regex`` package by
an equivalent stdlib pattern. :func:`tokenize` frames each text with
``<|startoftext|>``/``<|endoftext|>`` and pads to ``context_length``
(``clip/clip.py:197-237``). ``HashTokenizer`` is the vocabulary-free stand-in
with stable word-hash ids, for tests and random-weight runs.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte↔unicode table (reversible, no whitespace/control chars)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE,
)


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        if not os.path.isfile(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE vocab not found at {bpe_path}; download "
                "bpe_simple_vocab_16e6.txt.gz from the public CLIP release."
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    texts: Sequence[str],
    tokenizer: SimpleTokenizer,
    context_length: int = 77,
    truncate: bool = True,
) -> np.ndarray:
    """→ int32 [len(texts), context_length] (clip/clip.py:197-237)."""
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            if not truncate:
                raise ValueError(f"text too long: {text!r}")
            tokens = tokens[: context_length - 1] + [eot]
        out[i, : len(tokens)] = tokens
    return out


class HashTokenizer:
    """Vocab-free stand-in tokenizer for tests (no BPE file in this image):
    stable word-hash ids in [1000, vocab_size−3)."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.encoder = {
            "<|startoftext|>": vocab_size - 2,
            "<|endoftext|>": vocab_size - 1,
        }

    def encode(self, text: str) -> List[int]:
        words = whitespace_clean(basic_clean(text)).lower().split()
        lo, hi = 1000, self.vocab_size - 2
        import hashlib

        return [
            lo + int(hashlib.md5(w.encode()).hexdigest(), 16) % (hi - lo)
            for w in words
        ]
