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

On a CUDA device without a mesh the decode step is a CUDA graph: the first
step runs eagerly on the engine's capture stream (which builds every
kernel, cuBLAS's workspace and decode attention's tickets for that
stream), then captures ``model.decode_step`` for all ``slots`` rows, and
every later step replays it.  The graph reads and writes fixed addresses,
so its buffers are static: the params, the cache (written in place by the
steps and by ``insert``'s prefill, and never rebound), the token buffer
``tokens`` (slots, 1), which steps and inserts write in place, and the
logits.  Greedy, the graph also writes the argmax into ``tokens``; with a
temperature the host samples from the static logits and copies its tokens
in.  Only the chosen tokens' copy to the host lies outside the graph;
nothing inside ``decode_step`` waits for the card.  A replay adds the
captured step's launches to the kernels' ``LAUNCHES`` counters, so that
they count what the card ran.  On the CPU and on a mesh (DTensor dispatch
is not captured) every step runs eagerly.

``device=None`` means the card (and raises without one); tests pass
``device="cpu"``, where every kernel runs its plain version.  ``mesh`` /
``rules`` pass on to the model's prefill and decode steps; the cache is
laid out by ``decode_cache_axes`` and ``params`` are expected as DTensors
on that mesh.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.distributed.sharding import is_dtensor, shard_tree
from repro_torch.models.transformer import (decode_cache_axes,
                                            init_decode_cache)


def _launch_counters() -> list[dict]:
    """Every kernel wrapper's launch counters: its ``LAUNCHES`` and, where
    it has one, its ``PATH_LAUNCHES``."""
    from repro_torch.kernels import (attn_lstm_seq, decode_attention,
                                     flash_attention, lstm_cell, lstm_seq,
                                     rmsnorm, ssd_scan)
    mods = (attn_lstm_seq, decode_attention, flash_attention, lstm_cell,
            lstm_seq, rmsnorm, ssd_scan)
    return [c for m in mods for c in (m.LAUNCHES, getattr(
        m, "PATH_LAUNCHES", None)) if c is not None]


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
        # the step as a CUDA graph, captured at the end of the first step;
        # every decoder-only family captures (the card's tests hold each
        # one's replay to its eager step)
        self.graphed = self.device.type == "cuda" and mesh is None
        self.graph = None
        self._stream = torch.cuda.Stream(self.device) if self.graphed \
            else None
        self._logits = None              # the graph's static logits
        self._replay_launches = []       # (counter, {kernel: launches})

    @property
    def _argmax_on_card(self) -> bool:
        return self.graphed and self.temperature <= 0

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
    def _decode(self):
        """The step's work on the device: the model's decode step over every
        slot and, where greedy runs on the card, the argmax written into
        ``tokens``.  Returns the logits (slots, 1, V)."""
        logits, _ = self.model.decode_step(self.params, self.cache,
                                           self.tokens, mesh=self.mesh,
                                           rules=self.rules)
        if self._argmax_on_card:
            self.tokens.copy_(torch.argmax(logits[:, 0], dim=-1,
                                           keepdim=True))
        return logits

    def _decode_on_capture_stream(self):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            logits = self._decode()
        cur.wait_stream(self._stream)
        return logits

    def _capture(self, n: int):
        """Capture ``_decode`` on the capture stream, after a step ran there
        eagerly.  Capture runs nothing on the card, so the kernels' launch
        counters are set back to what they were, and what the capture added
        is added again at each replay."""
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector is off while capturing: a dead engine's graph
        # in a reference cycle, freed on this thread mid-capture, would
        # destroy a CUDA graph there and invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.span("engine.graph.capture", key=n):
                # thread_local: another thread of the process (a plane's
                # pool, a refit's worker) may allocate on the card meanwhile
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    self._logits = self._decode()
        finally:
            if collecting:
                gc.enable()
        self._replay_launches = []
        for c, b in zip(counters, before):
            added = {k: c[k] - b[k] for k in c if c[k] != b[k]}
            c.update(b)
            if added:
                self._replay_launches.append((c, added))
        self.graph = graph

    def _replay(self):
        self.graph.replay()
        for c, added in self._replay_launches:
            for k, n in added.items():
                c[k] += n
        return self._logits

    def step(self) -> list[tuple[int, list[int]]]:
        """One decode step for all slots; returns finished requests as
        (request_id, generated_tokens).  On a CUDA device without a mesh
        the first step runs eagerly on the capture stream and then captures
        the step; every later step replays that graph (span
        ``engine.step.replay``) over the same cache, token and logit
        buffers, so neither the cache nor ``tokens`` may ever be rebound."""
        if all(not s.active for s in self.slot_state):
            return []
        n = self.steps + 1
        with tracing.span("engine.step", key=n):
            # dispatch: every launch of the step is enqueued, nothing syncs
            with tracing.span("engine.step.dispatch", key=n):
                if self.graph is not None:
                    with tracing.span("engine.step.replay", key=n):
                        logits = self._replay()
                elif self.graphed:
                    logits = self._decode_on_capture_stream()
                else:
                    logits = self._decode()
            # wait: the chosen tokens' copy to the host waits for the card
            with tracing.span("engine.step.wait", key=n):
                if self._argmax_on_card:
                    nxt = self.tokens[:, 0].cpu().numpy()
                else:
                    nxt = self._select_token(logits[:, 0])
            if not self._argmax_on_card:
                self.tokens.copy_(torch.as_tensor(nxt, dtype=torch.long)[
                    :, None])
            if self.graphed and self.graph is None:
                self._capture(n)
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
