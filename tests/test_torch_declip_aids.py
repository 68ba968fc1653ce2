"""The DeCLIP pretraining aids and the small config surfaces against
pevit_tpu's:

* NNCLR's memory bank (``models/nnclr.py``): top-k neighbours, enqueue,
  the truncating wraparound and the pre-update snapshot, exactly equal to
  pevit_tpu.models.nnclr on one seeded bank;
* MLM corruption (``data/mlm.py``): special tokens never touched, labels
  the original ids at the selected positions and -100 elsewhere, and the
  15% selection and 80/10/10 split within binomial bounds;
* the local dataset hub and the legacy ``MODEL_SPECS`` equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.config import models as jmodels
from pevit_tpu.data import hub as jhub
from pevit_tpu.data import mlm as jmlm
from pevit_tpu.models import nnclr as jn
from pevit_tpu_torch.config import models as pmodels
from pevit_tpu_torch.data import hub as phub
from pevit_tpu_torch.data.mlm import IGNORE_INDEX, mask_tokens
from pevit_tpu_torch.models import nnclr as pn

SIZE, DIM, TOPK = 16, 8, 3


def _banks(seed=0):
    """One seeded unit-norm bank in both packages' state."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((SIZE, DIM)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return (jn.MemoryBankState(bank=jnp.asarray(rows), ptr=jnp.zeros((), jnp.int32)),
            pn.MemoryBankState(bank=torch.from_numpy(rows.copy()), ptr=0), rng)


def test_topk_neighbours_equal_jax():
    js, ps, rng = _banks()
    x = rng.standard_normal((5, DIM)).astype(np.float32)
    want = np.asarray(jn.nearest_neighbours(js, jnp.asarray(x), topk=TOPK))
    got = pn.nearest_neighbours(ps, torch.from_numpy(x), topk=TOPK).numpy()
    assert got.shape == want.shape == (TOPK, 5, DIM)
    np.testing.assert_array_equal(got, want)
    # neighbours come back un-normalised: bank rows as stored
    assert any(np.array_equal(got[0, 0], r) for r in ps.bank.numpy())


@pytest.mark.parametrize("batch", [6, 5, 16, 20])
def test_enqueue_and_wraparound_equal_jax(batch):
    js, ps, rng = _banks(seed=1)
    for step in range(4):
        x = rng.standard_normal((batch, DIM)).astype(np.float32)
        jnn, js = jn.nn_replace(js, jnp.asarray(x), update=True, topk=TOPK)
        pnn, ps = pn.nn_replace(ps, torch.from_numpy(x), update=True, topk=TOPK)
        np.testing.assert_array_equal(pnn.numpy(), np.asarray(jnn))
        np.testing.assert_array_equal(ps.bank.numpy(), np.asarray(js.bank))
        assert ps.ptr == int(js.ptr), step
    if batch == 6:
        # 6, 12, then 12 + 6 >= 16: four rows written, the tail dropped, ptr 0
        assert ps.ptr == 6


def test_the_snapshot_is_taken_before_the_update():
    _, ps, rng = _banks(seed=2)
    x = torch.from_numpy(rng.standard_normal((4, DIM)).astype(np.float32))
    before = ps.bank.clone()
    nn1, ps2 = pn.nn_replace(ps, x, update=True, topk=1)
    assert torch.equal(ps.bank, before)  # the old state is not changed in place
    nn2, _ = pn.nn_replace(ps2, x, update=False, topk=1)
    torch.testing.assert_close(nn2[0], x, rtol=0, atol=0)  # now it finds itself
    assert not torch.allclose(nn1[0], x)


def test_init_is_unit_norm_and_rejects_an_empty_bank():
    st = pn.init_memory_bank(torch.Generator().manual_seed(0), SIZE, DIM)
    torch.testing.assert_close(torch.linalg.norm(st.bank, dim=1), torch.ones(SIZE))
    assert st.ptr == 0
    with pytest.raises(ValueError, match="memory bank size"):
        pn.init_memory_bank(torch.Generator(), 0, DIM)


VOCAB, MASK, SOT, EOT = 49409, 49408, 49406, 49407


def _tokens(n=512, length=77, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 49000, (n, length))
    toks[:, 0], toks[:, -1] = SOT, EOT
    return torch.from_numpy(toks)


def test_mlm_never_touches_special_tokens():
    toks = _tokens()
    inputs, labels = mask_tokens(torch.Generator().manual_seed(0), toks, mask_token=MASK,
                                 vocab_size=VOCAB, special_tokens=(SOT, EOT, MASK))
    assert (inputs[:, 0] == SOT).all() and (inputs[:, -1] == EOT).all()
    assert (labels[:, 0] == IGNORE_INDEX).all() and (labels[:, -1] == IGNORE_INDEX).all()


def test_mlm_labels_and_untouched_positions():
    toks = _tokens()
    inputs, labels = mask_tokens(torch.Generator().manual_seed(1), toks, mask_token=MASK,
                                 vocab_size=VOCAB, special_tokens=(SOT, EOT))
    sel = labels != IGNORE_INDEX
    assert inputs.shape == labels.shape == toks.shape and inputs.dtype == toks.dtype
    assert torch.equal(labels[sel], toks[sel])  # the original ids where selected
    assert torch.equal(inputs[~sel], toks[~sel])  # everything else untouched
    assert IGNORE_INDEX == -100


def _within(k, n, p, sigmas=5.0):
    """k of n draws is within ``sigmas`` binomial standard deviations of n p."""
    return abs(k - n * p) <= sigmas * (n * p * (1 - p)) ** 0.5


def test_mlm_15_percent_and_80_10_10_within_binomial_bounds():
    toks = _tokens(n=2048)
    inputs, labels = mask_tokens(torch.Generator().manual_seed(2), toks, mask_token=MASK,
                                 vocab_size=VOCAB, special_tokens=(SOT, EOT))
    sel = labels != IGNORE_INDEX
    n_maskable, n_sel = toks.numel() - 2 * toks.shape[0], int(sel.sum())
    assert _within(n_sel, n_maskable, 0.15)
    masked = int((inputs[sel] == MASK).sum())
    kept = int((inputs[sel] == toks[sel]).sum())
    randomized = n_sel - masked - kept
    assert _within(masked, n_sel, 0.80)
    # a random id equals the original with probability 1/VOCAB: negligible
    assert _within(kept, n_sel, 0.10) and _within(randomized, n_sel, 0.10)


def test_mlm_explicit_mask_protects_everything_and_the_jax_contract_agrees():
    toks = _tokens(n=8)
    inputs, labels = mask_tokens(torch.Generator().manual_seed(3), toks, mask_token=MASK,
                                 vocab_size=VOCAB, special_tokens_mask=torch.ones_like(toks))
    assert torch.equal(inputs, toks) and (labels == IGNORE_INDEX).all()
    ji, jl = jmlm.mask_tokens(jax.random.PRNGKey(3), jnp.asarray(toks.numpy()), mask_token=MASK,
                              vocab_size=VOCAB, special_tokens_mask=jnp.ones(toks.shape, jnp.int32))
    assert jmlm.IGNORE_INDEX == IGNORE_INDEX
    np.testing.assert_array_equal(np.asarray(ji), inputs.numpy())
    np.testing.assert_array_equal(np.asarray(jl), labels.numpy())


def test_hub_lists_the_same_datasets_as_jax():
    want = jhub.get_dataset_hub().list_data_version_and_types()
    got = phub.get_dataset_hub().list_data_version_and_types()
    assert got == want and len(got) == 20
    assert phub.VISION_DATASET_STORAGE == jhub.VISION_DATASET_STORAGE


def test_hub_resolves_a_local_split_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "test.npz", images=rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
             labels=np.arange(4))
    jds, jinfo, _ = jhub.DatasetHub(str(tmp_path)).create_dataset_manifest(
        "https://example", str(tmp_path), "cifar-10", "test_purpose")
    pds, pinfo, _ = phub.DatasetHub(str(tmp_path)).create_dataset_manifest(
        "https://example", str(tmp_path), "cifar-10", "test_purpose")
    assert pinfo == jinfo and len(pds) == len(jds) == 4
    np.testing.assert_array_equal(pds.images, jds.images)
    np.testing.assert_array_equal(pds.labels, jds.labels)


def test_hub_missing_split_gives_none_or_raises_when_downloading(tmp_path):
    for hub in (jhub, phub):
        assert hub.DatasetHub(str(tmp_path)).create_dataset_manifest(
            "https://example", str(tmp_path), "cifar-10", "train_purpose") is None
        with pytest.raises(NotImplementedError):
            hub.DatasetHub(str(tmp_path), allow_download=True).create_dataset_manifest(
                "https://example", str(tmp_path), "cifar-10", "train_purpose")


def _flat(d, p=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, p + k + "."))
        else:
            out[p + k] = v
    return out


@pytest.mark.parametrize("name", ["HIGH_RESOLUTION_NET", "RESNEXT", "RESNET"])
def test_legacy_model_specs_equal_jax(name):
    got, want = getattr(pmodels, name), getattr(jmodels, name)
    assert type(got).__module__.startswith("pevit_tpu_torch")
    assert _flat(got) == _flat(want)
    assert set(pmodels.MODEL_SPECS) == set(jmodels.MODEL_SPECS) == {"cls_hrnet"}
    assert _flat(pmodels.MODEL_SPECS["cls_hrnet"]) == _flat(jmodels.MODEL_SPECS["cls_hrnet"])
