"""Deterministic synthetic token pipeline (port of
``repro.training.data``): zipf-ish LM data.

The same numpy generator calls as the reference, so the batches are
token-exact; they come back as int64 tensors on the pipeline's device.
The iterator state is (seed, step): resuming at a step replays the same
batch sequence.  ``next_embed_batch`` draws the encoder's frame
embeddings and labels on ``models.prng``'s copy of jax.random's threefry,
so its batches equal the reference's (the labels exactly, the bf16 frames
bit for bit: ``prng.normal_bf16``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import prng


@dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0


class TokenPipeline:
    """Markov-ish synthetic stream so next-token loss is learnable."""

    def __init__(self, cfg: DataConfig, step: int = 0, *, device="cuda"):
        self.cfg = cfg
        self.step = step
        self.device = torch.device(device)
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse transition preference: each token has 4 likely successors
        self._succ = rng.integers(0, v, size=(v, 4))

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def next_batch(self):
        """(inputs, labels), each (batch, seq_len) int64 on the device."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        b = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
        b[:, 0] = rng.integers(0, cfg.vocab_size, cfg.batch)
        explore = rng.random((cfg.batch, cfg.seq_len)) < 0.15
        choice = rng.integers(0, 4, (cfg.batch, cfg.seq_len))
        randtok = rng.integers(0, cfg.vocab_size, (cfg.batch, cfg.seq_len))
        for t in range(cfg.seq_len):
            succ = self._succ[b[:, t], choice[:, t]]
            b[:, t + 1] = np.where(explore[:, t], randtok[:, t], succ)
        self.step += 1
        tokens = torch.from_numpy(b.astype(np.int64)).to(self.device)
        return tokens[:, :-1], tokens[:, 1:]

    def next_embed_batch(self, d_model: int):
        """Frame-embedding batch for encoder archs (the reference's modality
        stub): key = fold_in(PRNGKey(seed), step), split in two; frames
        (batch, seq_len, d_model) bf16 standard normals from the first
        key, labels (batch, seq_len) int64 in [0, vocab) from the second,
        both on the device."""
        cfg = self.cfg
        key = prng.fold_in(prng.prng_key(torch.tensor(cfg.seed,
                                                      device=self.device)),
                           self.step)
        self.step += 1
        k1, k2 = prng.split(key)
        x = prng.normal_bf16(k1, (cfg.batch, cfg.seq_len, d_model))
        labels = prng.randint(k2, (cfg.batch, cfg.seq_len), 0,
                              cfg.vocab_size)
        return x, labels
