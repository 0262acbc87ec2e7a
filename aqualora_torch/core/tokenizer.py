"""CLIP BPE tokenizer and the deterministic fallback tokenizer.

A copy of `aqualora_tpu/core/tokenizer.py` (numpy only), kept here so the
port never imports the JAX package.  The vocab / merges files are not
bundled: pass paths to the standard `vocab.json` + `merges.txt`.
Without them, `FallbackTokenizer` gives a deterministic hash-based
tokenization for benchmarks and tests with random text-encoder weights.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import List, Sequence

import numpy as np

CONTEXT_LEN = 77


@functools.lru_cache()
def bytes_to_unicode():
    """Map bytes <-> printable unicode chars (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def _unicode_ranges_by_category() -> dict:
    """One scan of the Unicode database -> {first category letter:
    [(start, end), ...] codepoint ranges}.

    stdlib `re` lacks Unicode property classes, so the explicit ranges
    are built from `unicodedata`.  The scan of all ~1.1M codepoints
    costs ~0.4 s — doing it ONCE and bucketing by first letter serves
    both \\p{L} and \\p{N} (and any future class) from the same pass,
    instead of paying the scan per class at tokenizer construction.
    """
    import sys
    import unicodedata

    ranges: dict = {}
    open_runs: dict = {}           # letter -> [start, prev]
    for cp in range(sys.maxunicode + 1):
        letter = unicodedata.category(chr(cp))[0]
        run = open_runs.get(letter)
        if run is not None and run[1] == cp - 1:
            run[1] = cp
        else:
            if run is not None:
                ranges.setdefault(letter, []).append(tuple(run))
            open_runs[letter] = [cp, cp]
    for letter, run in open_runs.items():
        ranges.setdefault(letter, []).append(tuple(run))
    return ranges


@functools.lru_cache()
def _unicode_class(prefix: str) -> str:
    """Character-class body equivalent to \\p{<prefix>} (e.g. "L", "N").

    Built from the same Unicode database the `regex` library consults,
    this makes CLIPTokenizer's word splitting agree with the
    reference's `transformers` CLIPTokenizer
    (`train/ppft_train.py:848-850`) on non-ASCII prompts too — accented
    words, CJK, Arabic-Indic digits — where the former ASCII
    approximation ([a-zA-Z]+|[0-9]) silently split words differently
    (e.g. "café" -> "caf" + "é").
    """
    return "".join(
        re.escape(chr(a)) if a == b
        else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in _unicode_ranges_by_category()[prefix])


class CLIPTokenizer:
    """Byte-level BPE with CLIP's `</w>` word-end convention."""

    def __init__(self, vocab_path: str, merges_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        if vocab_path.endswith(".gz"):
            with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
                first = f.read()
            # openai ships a single bpe_simple_vocab gz of merges
            merges = first.split("\n")[1:48895]
            merges = [tuple(m.split()) for m in merges]
            base = list(self.byte_encoder.values())
            vocab = base + [v + "</w>" for v in base]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = {v: i for i, v in enumerate(vocab)}
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
        else:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
            if merges_path is None:
                merges_path = os.path.join(os.path.dirname(vocab_path),
                                           "merges.txt")
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
            lines = [l for l in lines if l and not l.startswith("#version")]
            self.bpe_ranks = {tuple(l.split()): i for i, l in enumerate(lines)}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # CLIP's exact word-split pattern: \p{L}+ | \p{N} | catch-all,
        # with the property classes expanded to explicit Unicode ranges
        # (stdlib `re` lacks \p{..}; see _unicode_class).
        L, N = _unicode_class("L"), _unicode_class("N")
        self.pat = re.compile(
            rf"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            rf"""[{L}]+|[{N}]|[^\s{L}{N}]+""", re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str] | str,
                 context_len: int = CONTEXT_LEN) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_len), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: context_len - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class FallbackTokenizer:
    """Deterministic hash tokenizer for tests/benchmarks (no vocab files).

    Same interface and padding convention as CLIPTokenizer; token ids are
    stable across processes (md5-based, not python hash()).
    """

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        import hashlib
        words = _whitespace_clean(_basic_clean(text)).lower().split()
        return [int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                % (self.vocab_size - 2) for w in words]

    def __call__(self, texts: Sequence[str] | str,
                 context_len: int = CONTEXT_LEN) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_len), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: context_len - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(vocab_path: str | None = None,
                   merges_path: str | None = None,
                   vocab_size: int = 49408):
    """CLIPTokenizer when vocab files are supplied/found, else fallback."""
    if vocab_path and os.path.exists(vocab_path):
        return CLIPTokenizer(vocab_path, merges_path)
    return FallbackTokenizer(vocab_size)
