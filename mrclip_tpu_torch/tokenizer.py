"""CLIP byte-level BPE tokenizer, NumPy only: the port's copy of
`mrclip_tpu/tokenizer.py::SimpleTokenizer` and its text cleaning.

Token ids are those of the JAX package (and of the reference open_clip) for
the shipped `bpe_simple_vocab_16e6.txt.gz`. Output is an int32 ndarray
`[n, context_length]`. The HF tokenizers and the context-overflow reduction
strategies are not ported yet (ROADMAP: modules item 3).
"""

from __future__ import annotations

import gzip
import html
import os
import string
from functools import lru_cache
from typing import Callable, List, Optional, Union

import numpy as np

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:  # pragma: no cover - ftfy is optional
    _HAS_FTFY = False

import regex as re

from .constants import DEFAULT_CONTEXT_LENGTH

__all__ = ["SimpleTokenizer", "tokenize", "decode", "DEFAULT_CONTEXT_LENGTH"]


@lru_cache()
def default_bpe_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "assets", "bpe_simple_vocab_16e6.txt.gz"
    )


@lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode mapping used by the GPT-2/CLIP BPE."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in keep}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


def _adjacent_pairs(symbols) -> set:
    return set(zip(symbols[:-1], symbols[1:]))


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def canonicalize_text(
    text: str,
    *,
    keep_punctuation_exact_string: Optional[str] = None,
    trans_punctuation: dict = str.maketrans("", "", string.punctuation),
) -> str:
    """Underscores to spaces, punctuation dropped (except inside
    `keep_punctuation_exact_string`), lower case, whitespace collapsed."""
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(trans_punctuation) for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(trans_punctuation)
    text = text.lower()
    return " ".join(text.split()).strip()


def get_clean_fn(kind: str) -> Callable[[str], str]:
    if kind == "canonicalize":
        return lambda x: canonicalize_text(basic_clean(x))
    if kind == "lower":
        return lambda x: whitespace_clean(basic_clean(x)).lower()
    if kind == "whitespace":
        return lambda x: whitespace_clean(basic_clean(x))
    raise ValueError(f"Invalid clean function ({kind}).")


class SimpleTokenizer:
    """Byte-level BPE tokenizer with CLIP vocab; emits int32 numpy arrays."""

    def __init__(
        self,
        bpe_path: Optional[str] = None,
        additional_special_tokens: Optional[List[str]] = None,
        context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH,
        clean: str = "lower",
    ):
        bpe_path = bpe_path or default_bpe_path()
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]

        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [tok + "</w>" for tok in base]
        vocab.extend("".join(m) for m in merges)
        specials = ["<start_of_text>", "<end_of_text>"]
        if additional_special_tokens:
            specials = specials + list(additional_special_tokens)
        vocab.extend(specials)

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self._bpe_cache = {tok: tok for tok in specials}
        self.pat = re.compile(
            "|".join(specials) + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[t] for t in specials]
        self.sot_token_id = self.all_special_ids[0]
        self.eot_token_id = self.all_special_ids[1]
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)

    def bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _adjacent_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)

        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = self.clean_fn(text)
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(self, texts: Union[str, List[str]], context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize into a zero-padded `[n, context_length]` int32 array.
        Overlong inputs are truncated with the final position forced to EOT."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        if not context_length:
            raise ValueError("no context length set")

        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


_default_tokenizer: Optional[SimpleTokenizer] = None


def _get_default() -> SimpleTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = SimpleTokenizer()
    return _default_tokenizer


def tokenize(texts: Union[str, List[str]], context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    return _get_default()(texts, context_length=context_length)


def decode(tokens) -> str:
    return _get_default().decode(tokens)
