"""Masked-language-model token corruption (BERT's 80/10/10).

Counterpart of ``pevit_tpu/data/mlm.py`` (reference
models/declip_model/utils/text_utils/mask_tokens.py:5-37, called by the
DeCLIP family's text tower in pretraining with ``text_mask_type='MLM'``;
the benchmark's evaluation never enables it).  A plain function on
tensors, drawing from an explicit ``torch.Generator``:

* each non-special token is selected with probability ``mlm_probability``;
* labels are the original ids at the selected positions and -100 (the
  loss's ignore index) elsewhere;
* of the selected, 80% become ``mask_token``, and of the rest a coin of
  p = 0.5 makes half a uniformly random vocabulary id, the other half
  unchanged (10% / 10%).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["IGNORE_INDEX", "mask_tokens"]

IGNORE_INDEX = -100


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor, *, mask_token: int,
                vocab_size: int, special_tokens: Sequence[int] = (),
                mlm_probability: float = 0.15,
                special_tokens_mask: Optional[torch.Tensor] = None) -> tuple:
    """Corrupt ``tokens`` (integer ids, any shape) for MLM training; returns
    ``(inputs, labels)``.  Positions holding one of ``special_tokens`` are
    never selected; ``special_tokens_mask`` (same shape, 1 = protected)
    replaces that test.  ``generator`` lies on the tokens' device."""
    tokens = torch.as_tensor(tokens)
    if special_tokens_mask is None:
        protected = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
        for t in special_tokens:
            protected |= tokens == t
    else:
        protected = torch.as_tensor(special_tokens_mask, device=tokens.device).bool()

    def coin(p: float) -> torch.Tensor:
        return torch.rand(tokens.shape, generator=generator, device=tokens.device) < p

    selected = coin(mlm_probability) & ~protected
    labels = torch.where(selected, tokens, torch.full_like(tokens, IGNORE_INDEX))
    replaced = coin(0.8) & selected
    randomized = coin(0.5) & selected & ~replaced
    random_words = torch.randint(0, vocab_size, tokens.shape, generator=generator,
                                 device=tokens.device, dtype=tokens.dtype)
    inputs = torch.where(replaced, torch.full_like(tokens, mask_token), tokens)
    inputs = torch.where(randomized, random_words, inputs)
    return inputs, labels
