"""Synthetic deterministic data, as the JAX package's ``training/data.py``.

A batch is a pure function of ``(seed, step)``: each draws from a
``torch.Generator`` on the CPU seeded from the pair, so a restarted run
reads the same stream and a batch does not depend on the device it lands
on. The numbers are the port's own: JAX's threefry cannot be reproduced
without JAX, so tests that compare the two packages feed both JAX's
batches. On a training mesh the step takes this global batch and each
position reads its rows of it, batch rows over ``(pod, data)``
(:meth:`~repro_torch.models.parallel.RowLayout.rows`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..models.common import ModelConfig

__all__ = ["SyntheticLM", "make_batch"]


def _generator(seed: int, step: int) -> torch.Generator:
    """A generator for one (seed, step) pair (the JAX ``fold_in``)."""
    return torch.Generator().manual_seed((seed << 32) + step)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish synthetic token stream (non-uniform so loss can drop)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        """{"tokens", "labels": [B, S] int64} on the CPU; labels are the
        tokens shifted by one."""
        gen = _generator(self.seed, step)
        B, S = self.global_batch, self.seq_len
        # Zipf-flavored marginals: low token ids much more likely.
        ranks = torch.arange(self.vocab_size, dtype=torch.float32) + 1.0
        probs = torch.softmax(-1.2 * torch.log(ranks), dim=0)
        base = torch.multinomial(probs, B * (S + 1), replacement=True,
                                 generator=gen).reshape(B, S + 1)
        # Local structure: with p=0.5 repeat previous token + 1 (learnable).
        rep = torch.rand((B, S + 1), generator=gen) < 0.5
        shifted = torch.roll(base, 1, dims=1)
        tokens = torch.where(rep, (shifted + 1) % self.vocab_size, base)
        return {"tokens": tokens[:, :S], "labels": tokens[:, 1:]}


def make_batch(cfg: ModelConfig, data: SyntheticLM, step: int, extras: dict | None = None,
               *, device: str | torch.device | None = None) -> dict:
    """Batch plus the modality stubs, on ``device`` (default CUDA): a
    patches frontend (internvl2) gets ``patch_embeds`` [B, P, frontend_dim]
    with P = min(n_frontend_tokens, seq_len), an encoder-decoder ``frames``
    [B, S, frontend_dim], both standard normal in the compute dtype, as
    JAX's ``make_batch``."""
    device = resolve_device(device)
    b = data.batch(step)
    B, S = data.global_batch, data.seq_len
    if cfg.frontend == "patches":
        P = min(cfg.n_frontend_tokens, S)
        b["patch_embeds"] = torch.randn((B, P, cfg.frontend_dim),
                                        generator=_generator(data.seed + 7, step))
    if cfg.is_encdec:
        b["frames"] = torch.randn((B, S, cfg.frontend_dim),
                                  generator=_generator(data.seed + 13, step))
    b = {k: v.to(cfg.compute_dtype) if v.is_floating_point() else v for k, v in b.items()}
    if extras:
        b.update(extras)
    return {k: v.to(device) for k, v in b.items()}
