"""The text tower and the text-feature head init against pevit_tpu, fp32,
with the weights carried by the bridge (text width 64, 8 heads, 2 layers,
context 77, the full 49408-token vocabulary so that real prompts tokenize):

* ``encode_text`` equals the JAX function at 1e-5 of the largest feature, at
  LayerNorm eps 1e-5 and 1e-12, on real prompts;
* ``extract_text_features`` for cifar-10 equals the JAX function at 1e-5,
  plain and knowledge-augmented (Wiktionary definitions + GPT-3 items, and
  the WordNet hierarchy);
* ``build_prompts`` gives the same texts and offsets for every dataset with
  metadata, plain and with each knowledge source;
* the bridge carries the text tower both ways bit for bit, and the masked
  attention never reaches the attention kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.core import CLIPSpec, TextSpec, VisionSpec, init_clip_params
from pevit_tpu.core import clip as jclip
from pevit_tpu.data.prompts import _load
from pevit_tpu.evaluation import text_features as jtf
from pevit_tpu_torch import bridge
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.core import clip as port_clip
from pevit_tpu_torch.core import layers as port_layers
from pevit_tpu_torch.data.tokenizer import tokenize
from pevit_tpu_torch.evaluation import text_features as ptf

TOL = 1e-5
SPEC = CLIPSpec(
    embed_dim=32,
    vision=VisionSpec(input_resolution=32, patch_size=16, width=64, layers=1, heads=1,
                      output_dim=32),
    text=TextSpec(context_length=77, vocab_size=49408, width=64, heads=8, layers=2, output_dim=32),
)
PORT_SPEC = port_clip.CLIPSpec(
    embed_dim=SPEC.embed_dim,
    vision=port_clip.VisionSpec(**dataclasses.asdict(SPEC.vision)),
    text=port_clip.TextSpec(**dataclasses.asdict(SPEC.text)),
)
KNOWLEDGE = {
    "plain": {},
    "wiki_gpt3": {"WIKITIONARY.USE_DEFINITION": True, "GPT3.USE_GPT3": True,
                  "AGGREGATION.NUM_GPT3_ITEMS": 2},
    "wordnet_then_gpt3": {"WORDNET.USE_HIERARCHY": True, "GPT3.USE_GPT3": True,
                          "AGGREGATION.MEHTOD": "WIKI_THEN_GPT3"},
    "wordnet_definition": {"WORDNET.USE_DEFINITION": True},
}


@pytest.fixture(scope="module", autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(3), SPEC))
    return params, bridge.clip_from_jax(params, PORT_SPEC, device="cpu")


def _config(make, dataset="cifar-10", knowledge=()):
    cfg = make()
    cfg.defrost()
    cfg.DATASET.DATASET = dataset
    for key, value in dict(knowledge).items():
        node, leaf = key.rsplit(".", 1)
        cfg.KNOWLEDGE[node][leaf] = value
    cfg.freeze()
    return cfg


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


@pytest.mark.parametrize("ln_eps", [1e-5, 1e-12])
def test_encode_text_matches_jax(weights, ln_eps):
    params, clip = weights
    texts, _ = ptf.build_prompts(_config(get_default_config))
    tokens = tokenize(texts[:24] + ["", "a " * 80], truncate=True)
    want = np.asarray(jclip.encode_text(params, jnp.asarray(tokens), spec=SPEC, ln_eps=ln_eps))
    with torch.no_grad():
        got = port_clip.encode_text(clip, torch.from_numpy(tokens).long(), spec=PORT_SPEC,
                                    ln_eps=ln_eps).numpy()
    assert got.shape == want.shape == (26, SPEC.embed_dim)
    _close(got, want, f"encode_text eps {ln_eps}")


@pytest.mark.parametrize("knowledge", ["plain", "wiki_gpt3", "wordnet_then_gpt3"])
def test_extract_text_features_matches_jax(weights, knowledge):
    params, clip = weights
    want = jtf.extract_text_features(_config(jax_defaults, knowledge=KNOWLEDGE[knowledge]),
                                     params, SPEC)
    got = ptf.extract_text_features(_config(get_default_config, knowledge=KNOWLEDGE[knowledge]),
                                    clip, PORT_SPEC, chunk=100)
    assert got.shape == want.shape == (SPEC.embed_dim, 10) and got.dtype == np.float32
    _close(got, want, f"text features {knowledge}")


DATASETS = sorted(_load("class_names.json"))


@pytest.mark.parametrize("knowledge", sorted(KNOWLEDGE))
@pytest.mark.parametrize("dataset", DATASETS)
def test_build_prompts_is_identical(dataset, knowledge):
    spec = KNOWLEDGE[knowledge]
    try:
        want = jtf.build_prompts(_config(jax_defaults, dataset, spec))
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            ptf.build_prompts(_config(get_default_config, dataset, spec))
        return
    assert ptf.build_prompts(_config(get_default_config, dataset, spec)) == want


def test_bridge_carries_the_text_tower_bit_exactly(weights):
    params, clip = weights
    back = bridge._from_state_dict(clip.state_dict(), bridge._STACKED["clip"])
    for path, want in bridge._flatten(params["text"]).items():
        node = back["text"]
        for k in path:
            node = node[k]
        assert node.dtype == want.dtype and np.array_equal(node, want), path
    assert set(bridge._flatten(back)) == set(bridge._flatten(params))
    assert bridge.stacked_layer_axes("clip.text.blocks.1.attn.in_proj.kernel") == 1
    assert bridge.stacked_layer_axes("clip.text.token_embedding") == 0


def test_masked_attention_never_reaches_the_kernel(weights, monkeypatch):
    _, clip = weights

    def kernel(*a):
        raise AssertionError("masked attention reached the attention kernel")

    monkeypatch.setattr(port_layers, "attention_core", kernel)
    monkeypatch.setattr(port_layers, "fused_mlp_residual", kernel)
    tokens = torch.from_numpy(tokenize(["a photo of a cat"])).long()
    with torch.no_grad():
        out = port_clip.encode_text(clip, tokens, spec=PORT_SPEC)
    assert out.shape == (1, SPEC.embed_dim) and torch.isfinite(out).all()
