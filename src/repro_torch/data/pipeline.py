"""Deterministic synthetic LM data (a copy of ``repro/data/pipeline.py``;
numpy only, so the port's batches are the reference's, bit for bit).

Host-sharded: each host materializes only its slice of the global batch,
and the stream is reproducible from (seed, step) alone — restart-safe
without data-state checkpoints (the trainer only records the step).
Token statistics follow a Zipfian distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2              # Zipf exponent (>1)
    sep_every: int = 128             # pseudo-document separator period


class SyntheticLM:
    """Stateless map-style stream: batch(step) -> {"tokens": (B, S)}."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 data_cfg: DataConfig = DataConfig(),
                 host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq_len = seq_len
        self.data_cfg = data_cfg
        self.host_index = host_index

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.data_cfg.seed, step, self.host_index]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        vocab = self.cfg.vocab_size
        # Zipf with rejection to the vocab range, offset past specials.
        z = rng.zipf(self.data_cfg.zipf_a,
                     size=(self.local_batch, self.seq_len))
        tokens = (z % (vocab - 2)) + 2
        tokens[:, ::self.data_cfg.sep_every] = 1          # separator id
        out: Dict[str, np.ndarray] = {"tokens": tokens.astype(np.int32)}
        if self.cfg.frontend is not None:
            out["frontend_embeds"] = rng.standard_normal(
                (self.local_batch, self.seq_len, self.cfg.frontend_dim),
                dtype=np.float32)
            if self.cfg.enc_dec:
                out["tokens"] = tokens[:, :self.cfg.dec_max_len]
            else:
                out["labels"] = out["tokens"]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
