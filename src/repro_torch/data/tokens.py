"""Deterministic synthetic LM data, the JAX package's ``data/tokens.py``.

Markov-chain token streams give a learnable distribution (the loss falls
under training) while staying offline and reproducible.  The numpy draw is
the reference's op for op: the successor table from
``default_rng(seed)``, each batch from ``default_rng((seed, step))``, so a
restarted run resumes with the same data order and both packages see the
same tokens.  With a ``mesh`` and ``rules`` every rank makes the same
global batch from the seed and keeps its own slice of it, laid out by
("batch", "seq") (``distribute_tensor(..., src_data_rank=None)``: no
scatter runs), as the reference ``device_put``s the batch onto its
``NamedSharding``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLMData:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, order: int = 1, mesh=None, rules=None,
                 device=None):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, global_batch
        self.seed = seed
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # sparse-ish Markov transition: each token strongly prefers ~4
        # successors
        k = 4
        self._succ = rng.integers(0, vocab, (vocab, k))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"} (B, S) int32 tensors on the data's device
        (None at construction: the card); DTensors on a mesh."""
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, self._succ.shape[1],
                               (self.batch, self.seq_len))
        noise = rng.random((self.batch, self.seq_len)) < 0.1
        rand_tok = rng.integers(0, self.vocab, (self.batch, self.seq_len))
        for t in range(self.seq_len):
            nxt = self._succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in (("tokens", toks[:, :-1]),
                            ("labels", toks[:, 1:]))}
        if self.mesh is not None and self.rules is not None:
            from torch.distributed.tensor import distribute_tensor

            from repro_torch.distributed.sharding import named_sharding
            for k, v in out.items():
                _, pl = named_sharding(("batch", "seq"), v.shape, self.rules,
                                       self.mesh)
                out[k] = distribute_tensor(v, self.mesh, pl,
                                           src_data_rank=None)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
