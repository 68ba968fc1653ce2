"""CLIP BPE tokenizer.

Counterpart of ``pevit_tpu/data/tokenizer.py``: the byte-level BPE of
OpenAI CLIP over ``resources/bpe_simple_vocab_16e6.txt.gz``, with the same
text cleanup (double html unescape, NFKC, whitespace runs to one space,
lower case) and the same ``tokenize`` contract (start/end tokens, zero
padding to the context length, error or truncate on overflow).

The reference splits words with the third-party ``regex`` module's pattern
``<\\|startoftext\\|>|...|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` under
IGNORECASE.  The card's Python has no ``regex``, and the standard ``re`` has
no ``\\p{..}`` classes (its ``\\w`` is ``isalnum() or "_"``, its ``\\d`` Nd
only, its ``\\s`` ``isspace()``).  So the classes are built here, when the
module is imported, from ``unicodedata`` -- letters (L*), numbers (N*),
White_Space -- and the special tokens and contractions keep their
case-insensitive match in a scoped ``(?i:...)`` group.  Two quirks of the
reference's pattern are kept: ``regex``'s ``\\s`` is the White_Space property,
which leaves out U+001C..U+001F (``str.isspace`` counts them), and under
IGNORECASE a character that is no letter or number but case-maps to one
(U+0345, whose upper case is a Greek capital) is matched by neither the
letter class nor the negated class, so it is dropped.  The tests hold the
classes to ``regex`` on every character assigned in this Python's Unicode
database; characters that a newer Unicode assigns and this one does not may
still differ.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import List, Union

import numpy as np

_DEFAULT_BPE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources",
    "bpe_simple_vocab_16e6.txt.gz",
)

# Other_Alphabetic symbols (category So) that ``regex``'s ``\w`` counts as
# letters; unicodedata does not expose the property, only their names
_ALPHABETIC_SYMBOL = re.compile(r"CIRCLED LATIN SMALL LETTER [A-Z]"
                                r"|(NEGATIVE )?(CIRCLED|SQUARED) LATIN CAPITAL LETTER [A-Z]")


def _class(codepoints) -> str:
    """A character-class body (no brackets) for sorted code points."""
    out, start, prev = [], None, None
    for cp in list(codepoints) + [None]:
        if start is not None and cp == prev + 1:
            prev = cp
            continue
        if start is not None:
            out.append(f"\\U{start:08x}" if start == prev else f"\\U{start:08x}-\\U{prev:08x}")
        start = prev = cp
    return "".join(out)


def _build_classes() -> dict:
    cats = [unicodedata.category(chr(cp)) for cp in range(0x110000)]
    space = [cp for cp in range(0x110000) if chr(cp).isspace() and not 0x1C <= cp <= 0x1F]
    letter = [cp for cp, c in enumerate(cats) if c[0] == "L"]
    number = [cp for cp, c in enumerate(cats) if c[0] == "N"]

    def case_maps_to_letter_or_number(cp: int) -> bool:
        ch = chr(cp)
        return any(len(v) == 1 and unicodedata.category(v)[0] in "LN"
                   for v in (ch.upper(), ch.lower(), ch.casefold()))

    folded = [cp for cp, c in enumerate(cats)
              if c[0] not in "LN" and c not in ("Cn", "Cs", "Co") and case_maps_to_letter_or_number(cp)]
    word = [cp for cp, c in enumerate(cats)
            if c[0] in "LM" or c in ("Nd", "Nl", "Pc") or cp in (0x200C, 0x200D)
            or (c == "So" and _ALPHABETIC_SYMBOL.fullmatch(unicodedata.name(chr(cp), "")))]
    return {"space": _class(space), "letter": _class(letter), "number": _class(number),
            "folded": _class(folded), "word": _class(word)}


CLASSES = _build_classes()
_SPACE_RUN = re.compile(f"[{CLASSES['space']}]+")
WORD_PATTERN = re.compile(
    r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
    f"|[{CLASSES['letter']}]+|[{CLASSES['number']}]"
    f"|[^{CLASSES['space']}{CLASSES['letter']}{CLASSES['number']}{CLASSES['folded']}]+"
)


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP scheme)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFKC", text)
    text = _SPACE_RUN.sub(" ", text)
    return text.strip().lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = _DEFAULT_BPE):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
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
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

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
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in WORD_PATTERN.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@lru_cache(maxsize=1)
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, List[str]], context_length: int = 77, truncate: bool = False
) -> np.ndarray:
    """Reference-contract tokenize (clip_load.py:484-516): (N, L) int32."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.encoder["<|startoftext|>"], tok.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tok.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(f"Input {texts[i]!r} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
