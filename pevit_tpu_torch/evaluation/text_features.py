"""Zero-shot text features: the classifier head's initial weights.

Counterpart of ``pevit_tpu/evaluation/text_features.py`` (reference
``extract_text_features``, feature.py:405-531): per class, format every
prompt template (optionally augmented with WordNet / Wiktionary / GPT-3
knowledge), tokenize, encode with the text tower, L2-normalise each
embedding, average over the class's prompts and renormalise.  Returns
(embed_dim, K).

All prompts of all classes tokenize on the host and encode in chunks of
natural size on the tower's device, in float32.  The rows of the text tower
are independent (it carries no PEFT scramble), so, unlike the reference, the
last chunk is not padded.  The normalisation and the class means run on the
host in numpy, as in the reference.

Knowledge text is word-split with the reference's ``\\w+|[^\\w\\s]`` (an
nltk.word_tokenize stand-in), whose ``\\w`` and ``\\s`` are the third-party
``regex`` module's; the classes are the tokenizer's (``data/tokenizer.py``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from ..core.clip import CLIPSpec, encode_text
from ..data.prompts import get_class_names, get_templates
from ..data.tokenizer import CLASSES, tokenize

_WORD_RE = re.compile(f"[{CLASSES['word']}]+|[^{CLASSES['word']}{CLASSES['space']}]")


def _word_tokenize(text: str) -> list:
    """nltk.word_tokenize stand-in for the knowledge text (feature.py:505)."""
    return _WORD_RE.findall(text)


def _load_knowledge_dict(config, kind: str) -> dict:
    """The wiki / wordnet knowledge dict (feature.py:416-459)."""
    wiki_path = config.KNOWLEDGE.WIKITIONARY.WIKI_DICT_PATH
    tsv = os.path.join(wiki_path, config.DATASET.DATASET + "_knowledge.tsv")
    with open(tsv, encoding="utf-8") as f:
        entries = json.load(f)
    out = {}
    count = 0
    for k2v in entries:
        if kind == "def_wiki":
            val = k2v["def_wiki"]
        elif kind == "def_wn":
            val = k2v["def_wn"]
        else:  # hierarchy (feature.py:442-459): the first <= 3 wordnet path items
            path_wn = k2v["path_wn"]
            val = " ".join(path_wn[: min(3, len(path_wn))]) if len(path_wn) > 0 else path_wn
        out[k2v["classname"]] = val
        if val:
            count += 1
    logging.info("knowledge coverage is %d / %d", count, len(out))
    return out


def _load_gpt3_dict(config) -> dict:
    gpt3_tsv = os.path.join(
        config.KNOWLEDGE.GPT3.GPT3_DICT_PATH, "GPT3_" + config.DATASET.DATASET + ".tsv"
    )
    with open(gpt3_tsv, encoding="utf-8") as f:
        entries = json.load(f)
    return {k2v["classname"]: k2v["gpt3"] for k2v in entries}


def build_prompts(config, class_names: Optional[list] = None) -> tuple:
    """All prompt texts as (texts, class_offsets): ``texts`` is the flat
    list over classes x templates (x knowledge items), and
    ``class_offsets[i]`` slices class i's prompts out of it."""
    dataset = config.DATASET.DATASET
    if class_names is None:
        class_names = get_class_names(dataset)
    if not class_names:
        raise ValueError(f"No class names known for dataset {dataset!r}")
    templates = get_templates(dataset)

    use_wiki = config.KNOWLEDGE.WIKITIONARY.USE_DEFINITION
    use_wn_def = config.KNOWLEDGE.WORDNET.USE_DEFINITION
    use_wn_hier = config.KNOWLEDGE.WORDNET.USE_HIERARCHY
    use_gpt3 = config.KNOWLEDGE.GPT3.USE_GPT3

    wiki_dict = {}
    if use_wiki:
        wiki_dict = _load_knowledge_dict(config, "def_wiki")
    elif use_wn_def:
        wiki_dict = _load_knowledge_dict(config, "def_wn")
    elif use_wn_hier:
        wiki_dict = _load_knowledge_dict(config, "hierarchy")
    gpt3_dict = _load_gpt3_dict(config) if use_gpt3 else {}

    texts, offsets = [], []
    wiki_count = gpt3_count = 0
    for classname in class_names:
        if isinstance(classname, list):
            classname = classname[0]
        knowledge_text_list = []
        if (use_wiki or use_wn_def or use_wn_hier) and classname in wiki_dict:
            knowledge_text_list.append(wiki_dict[classname])
            wiki_count += 1
        if use_gpt3:
            method = config.KNOWLEDGE.AGGREGATION.MEHTOD
            n_items = config.KNOWLEDGE.AGGREGATION.NUM_GPT3_ITEMS
            if method == "WIKI_AND_GPT3" or (method == "WIKI_THEN_GPT3" and not knowledge_text_list):
                for kt in gpt3_dict.get(classname, [])[:n_items]:
                    knowledge_text_list.append(kt)
                    gpt3_count += 1

        aug = []
        for kt in knowledge_text_list:
            kt = f" ; {classname} , " + kt if kt is not None else ""
            aug.append(" " + " ".join(_word_tokenize(kt)))

        start = len(texts)
        if not aug:
            texts.extend(t.format(classname) for t in templates)
        else:
            texts.extend(t.format(classname) + k for k in aug for t in templates)
        offsets.append((start, len(texts)))
    logging.info("=> Knowledge source count | knowledge_count: %d | gpt3_count %d", wiki_count, gpt3_count)
    return texts, offsets


def extract_text_features(config, clip, spec: CLIPSpec, *, class_names: Optional[list] = None,
                          chunk: int = 256) -> np.ndarray:
    """Zero-shot classifier weights (embed_dim, K) from ``clip``'s text
    tower, run in float32 on the tower's device."""
    start = time.time()
    texts, offsets = build_prompts(config, class_names)
    tokens = tokenize(texts, context_length=config.MODEL.SPEC.TEXT.CONTEXT_LENGTH, truncate=True)
    dev = clip.text.token_embedding.device
    feats = []
    with torch.no_grad():
        for s in range(0, len(tokens), chunk):
            batch = torch.from_numpy(tokens[s:s + chunk]).to(dev, torch.long)
            feats.append(encode_text(clip, batch, spec=spec).float().cpu().numpy())
    emb = np.concatenate(feats)  # (n_prompts, E)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12

    weights = []
    for s, e in offsets:
        mean = emb[s:e].mean(axis=0)
        weights.append(mean / (np.linalg.norm(mean) + 1e-12))
    zeroshot = np.stack(weights, axis=1)  # (E, K)
    logging.info("=> Feature extraction duration time: %.2fs", time.time() - start)
    return zeroshot
