"""Batched decode engine with slot-based continuous batching.

One engine instance == one model replica.  The KV cache holds ``slots``
independent sequences with per-slot lengths; requests are prefilled one at
a time straight into a free slot of the live cache, decode steps advance
every slot at once, and finished slots are recycled without stalling the
rest of the batch -- the JAX package's ``serving/engine.py``, whose static
buffers become one cache updated in place: an insert writes the prompt's
rows of one slot, a step one row a slot and layer, never a copy of the
whole cache.  Inactive slots keep decoding, as in the reference; their
length grows past ``max_len`` and their writes clamp to the last row.

``device=None`` means the card (and raises without one); tests pass
``device="cpu"``, where every kernel runs its plain version.  ``mesh`` /
``rules`` pass on to the model's prefill and decode steps; the cache is
laid out by ``decode_cache_axes`` and ``params`` are expected as DTensors
on that mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.distributed.sharding import is_dtensor, shard_tree
from repro_torch.models.transformer import (decode_cache_axes,
                                            init_decode_cache)


@dataclasses.dataclass
class SlotState:
    request_id: int = -1
    remaining: int = 0
    generated: list = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.request_id >= 0


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 8,
                 max_len: int = 512, temperature=0.0, seed: int = 0,
                 mesh=None, rules=None, device=None):
        """``params``: the model's nested dict of tensors, already on
        ``device``."""
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the engine serves decoder-only models; an "
                f"encoder-decoder model runs EncDecLM.encode, init_dec_cache "
                f"and decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.model = build_model(cfg)
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.mesh, self.rules = mesh, rules
        self.cache = shard_tree(
            init_decode_cache(cfg, slots, max_len, device=self.device),
            decode_cache_axes(cfg), rules, mesh)
        self.slot_state = [SlotState() for _ in range(slots)]
        self.tokens = torch.zeros((slots, 1), dtype=torch.long,
                                  device=self.device)
        self.steps = 0
        self.tokens_out = 0

    # ------------------------------------------------------------ slots ----
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slot_state) if not s.active]

    def utilization(self) -> float:
        return 1.0 - len(self.free_slots()) / self.slots

    def insert(self, request_id: int, prompt: np.ndarray, max_new: int) -> int:
        """Prefill a prompt into a free slot of the live cache."""
        with tracing.span("engine.prefill", key=request_id):
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slot")
            slot = free[0]
            toks = torch.as_tensor(np.asarray(prompt, np.int64),
                                   device=self.device)[None]
            logits, _ = self.model.prefill(self.params, toks, cache=self.cache,
                                           rows=[slot], mesh=self.mesh,
                                           rules=self.rules)
            first = self._select_token(logits[:, -1])[0]
            self.tokens[slot, 0] = int(first)
            st = self.slot_state[slot]
            st.request_id = request_id
            st.remaining = max_new
            st.generated = [int(first)]
            return slot

    def _select_token(self, logits):
        if is_dtensor(logits):
            logits = logits.full_tensor()
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        g = -np.log(-np.log(self.rng.uniform(size=tuple(logits.shape))))
        z = logits.float().cpu().numpy() / self.temperature + g
        return z.argmax(-1)

    # ------------------------------------------------------------- step ----
    def step(self) -> list[tuple[int, list[int]]]:
        """One decode step for all slots; returns finished requests as
        (request_id, generated_tokens)."""
        if all(not s.active for s in self.slot_state):
            return []
        n = self.steps + 1
        with tracing.span("engine.step", key=n):
            # dispatch: every launch of the step is enqueued, nothing syncs
            with tracing.span("engine.step.dispatch", key=n):
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache, self.tokens, mesh=self.mesh,
                    rules=self.rules)
            # wait: the argmax's copy to the host waits for the card
            with tracing.span("engine.step.wait", key=n):
                nxt = self._select_token(logits[:, 0])
            self.tokens = torch.as_tensor(nxt, dtype=torch.long,
                                          device=self.device)[:, None]
            self.steps = n
            finished = []
            for i, st in enumerate(self.slot_state):
                if not st.active:
                    continue
                st.generated.append(int(nxt[i]))
                st.remaining -= 1
                self.tokens_out += 1
                if st.remaining <= 0:
                    finished.append((st.request_id, st.generated))
                    self.slot_state[i] = SlotState()
            return finished
