"""Deterministic synthetic token pipeline.

The port's own copy of the JAX package's ``data/pipeline.py``.  It is numpy
code, so it is copied as it is: its batches are bitwise the reference's
(tokens, labels, patches and frames).  Every (step, sample, position) maps
to a token through a counter-mode hash, so the stream is:

* **deterministic** — any host can regenerate any batch, which is what makes
  checkpoint-restart exact (the data state is one integer);
* **slice-aware** — ``next_batch(local_slice)`` materializes only some rows
  of the global batch;
* **learnable** — tokens follow a periodic Markov-ish pattern (next token is
  a hash of the previous token and a per-sequence key) so a ~100M-model
  run shows a decreasing loss, not noise-floor flatlining.

The batches are numpy arrays; the caller moves them to the device
(``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _hash2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cheap 32-bit mix (xxhash-style), vectorized."""
    x = (a.astype(np.uint32) * np.uint32(2654435761)) ^ (
        b.astype(np.uint32) * np.uint32(2246822519))
    x ^= x >> np.uint32(13)
    x = x * np.uint32(3266489917)
    x ^= x >> np.uint32(16)
    return x


@dataclasses.dataclass
class SyntheticTextPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0                      # checkpointable state
    pattern_period: int = 64           # learnable structure strength

    def next_batch(self, local_slice: Optional[slice] = None
                   ) -> Dict[str, np.ndarray]:
        """Returns {tokens, labels} for this step; ``local_slice`` selects
        some rows of the global batch."""
        sl = local_slice or slice(0, self.global_batch)
        rows = np.arange(sl.start, sl.stop, dtype=np.uint32)
        pos = np.arange(self.seq_len + 1, dtype=np.uint32)
        seq_key = _hash2(rows + np.uint32(self.seed * 7919),
                         np.full_like(rows, self.step, dtype=np.uint32))
        # periodic structure: token depends on (sequence key, pos % period)
        grid = _hash2(seq_key[:, None], (pos[None, :] % self.pattern_period))
        # sprinkle position-dependent noise at low rate to avoid triviality
        noise = _hash2(seq_key[:, None] + np.uint32(1), pos[None, :])
        use_noise = (noise % np.uint32(17)) == 0
        tok = np.where(use_noise, noise, grid) % np.uint32(self.vocab)
        tok = tok.astype(np.int32)
        self.step += 1
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])


def make_batch_for(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                   step: int = 0, dtype=np.float32) -> Dict[str, np.ndarray]:
    """One concrete batch of ``shape``: ``tokens`` (B, S - n_patches),
    ``labels`` (B, S) for a train shape — a VLM's patch positions labelled
    0, and the loss counts them, as the reference's — and standard normal
    ``patches`` / ``frames`` where the model takes them."""
    s_text = shape.seq_len - cfg.n_patches if cfg.n_patches else shape.seq_len
    pipe = SyntheticTextPipeline(cfg.vocab, s_text, shape.global_batch,
                                 seed=seed, step=step)
    b = pipe.next_batch()
    batch: Dict[str, np.ndarray] = {"tokens": b["tokens"]}
    if shape.kind == "train":
        # labels span the full (patch + text) sequence for VLMs
        if cfg.n_patches:
            pad = np.zeros((shape.global_batch, cfg.n_patches), np.int32)
            batch["labels"] = np.concatenate([pad, b["labels"]], axis=1)
        else:
            batch["labels"] = b["labels"]
    rng = np.random.default_rng(seed + 1)
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (shape.global_batch, cfg.n_patches, cfg.d_model)).astype(dtype)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (shape.global_batch, cfg.encdec.enc_len, cfg.d_model)
        ).astype(dtype)
    return batch
