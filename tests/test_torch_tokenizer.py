"""The port's CLIP tokenizer (stdlib ``re`` with classes built from
``unicodedata``) against ``pevit_tpu.data.tokenizer`` (the ``regex``
module's ``\\p{L}``/``\\p{N}``), token for token:

* every class name and template of the 25 datasets in resources/metadata,
  and the formatted prompts of each dataset's first classes;
* every knowledge string under resources/knowledge;
* hypothesis unicode text (digits, No/Nl numbers, combining marks, ``_``,
  punctuation runs, the separators U+001C..U+001F, U+0345), with and
  without truncation;
* the character classes themselves, on every character this Python's
  Unicode database assigns, against the ``regex`` classes they stand for.
"""

import json
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from pevit_tpu.data import tokenizer as jt
from pevit_tpu.evaluation import text_features as jtf
from pevit_tpu_torch.data import tokenizer as pt
from pevit_tpu_torch.evaluation import text_features as ptf

REPO = Path(__file__).resolve().parents[1]
META = REPO / "resources" / "metadata"
CLASS_NAMES = json.loads((META / "class_names.json").read_text())
TEMPLATES = json.loads((META / "prompt_templates.json").read_text())
DATASETS = sorted(set(CLASS_NAMES) | set(TEMPLATES))
KNOWLEDGE = sorted(str(p.relative_to(REPO)) for p in (REPO / "resources" / "knowledge").rglob("*.tsv"))


def _same(texts, context_length=77, truncate=True):
    want = jt.tokenize(texts, context_length=context_length, truncate=truncate)
    got = pt.tokenize(texts, context_length=context_length, truncate=truncate)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_25_datasets_have_metadata():
    assert len(DATASETS) == 25


@pytest.mark.parametrize("dataset", DATASETS)
def test_class_names_templates_and_prompts(dataset):
    names = [n[0] if isinstance(n, list) else n for n in CLASS_NAMES.get(dataset, [])]
    templates = TEMPLATES.get(dataset, ["a photo of a {}"])
    _same(names + templates + [t.format(n) for n in names[:8] for t in templates])


def _strings(tree):
    if isinstance(tree, str):
        yield tree
    elif isinstance(tree, list):
        for x in tree:
            yield from _strings(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _strings(x)


@pytest.mark.parametrize("path", KNOWLEDGE)
def test_knowledge_strings(path):
    texts = sorted(set(_strings(json.loads((REPO / path).read_text()))))
    assert texts
    _same(texts)
    words = [" ".join(ptf._word_tokenize(t)) for t in texts]
    assert words == [" ".join(jtf._word_tokenize(t)) for t in texts]


_SPECIAL = "0123456789²³¼⅕Ⅳⅻ〇٣۴߄०১ੴ௰́̃ͅ҉_-.,;:!?'\"()[]{}<>|/\\@#$%^&*~` \t\n\x1c\x1d\x1e\x1f\xa0 ſKİı"
_ALPHABET = st.one_of(
    st.characters(exclude_categories=("Cs", "Cn")),
    st.sampled_from(_SPECIAL),
    st.sampled_from(["'s", "'S", "'ſ", "'ll", "<|startoftext|>", "<|endoftext|>", "&amp;", "&lt;"]),
)
_TEXT = st.lists(_ALPHABET, max_size=24).map("".join)


@settings(max_examples=400, deadline=None)
@given(_TEXT)
def test_hypothesis_text_encodes_the_same(text):
    assert pt.get_tokenizer().encode(text) == jt.get_tokenizer().encode(text)
    assert pt._clean(text) == jt._clean(text)
    assert ptf._word_tokenize(text) == jtf._word_tokenize(text)


@settings(max_examples=100, deadline=None)
@given(st.lists(_TEXT, min_size=1, max_size=4), st.integers(3, 20))
def test_hypothesis_truncation(texts, context_length):
    _same([t * 4 for t in texts], context_length=context_length, truncate=True)


def test_overflow_raises_without_truncation():
    for tok in (jt, pt):
        with pytest.raises(RuntimeError, match="too long"):
            tok.tokenize(["word " * 100], context_length=16)
    _same(["word " * 100, "a photo of a cat"], context_length=16)
    assert pt.get_tokenizer().encode("a photo of a cat") == [320, 1125, 539, 320, 2368]


def _assigned():
    return [chr(cp) for cp in range(0x110000) if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]


def test_classes_match_regex_on_every_assigned_character():
    """Each class of the port's patterns, one character at a time, against
    the ``regex`` class it stands for (with the reference's flags)."""
    ic = regex.IGNORECASE
    pairs = {
        "letter": (regex.compile(r"[\p{L}]", ic), f"[{pt.CLASSES['letter']}]"),
        "number": (regex.compile(r"[\p{N}]", ic), f"[{pt.CLASSES['number']}]"),
        "other": (regex.compile(r"[^\s\p{L}\p{N}]", ic),
                  f"[^{pt.CLASSES['space']}{pt.CLASSES['letter']}{pt.CLASSES['number']}"
                  f"{pt.CLASSES['folded']}]"),
        "space": (regex.compile(r"\s"), f"[{pt.CLASSES['space']}]"),
        "word": (regex.compile(r"\w"), f"[{pt.CLASSES['word']}]"),
    }
    import re

    chars = _assigned()
    for name, (want, mine) in pairs.items():
        mine = re.compile(mine)
        diff = [hex(ord(c)) for c in chars if bool(want.fullmatch(c)) != bool(mine.fullmatch(c))]
        assert not diff, (name, diff[:20])
