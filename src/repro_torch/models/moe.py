"""Mixture-of-Experts layer: top-k router + capacity-bounded sort dispatch,
the port of the JAX package's ``models/moe.py``.

Dispatch is gather/scatter-based (argsort by expert id, truncation to the
capacity) rather than one-hot einsums, and runs per batch row, as in the
reference: a row's tokens never compete with another row's for an expert's
capacity.  The rows are routed in one batched pass (the reference vmaps
over them).  The routing is plain PyTorch on x's device, as the reference
computes it outside any Pallas kernel, and so are the three expert
products (batched matmuls over the experts).

Ties: the top-k takes a stable descending sort of the probabilities, so of
two equal probabilities the lower expert id ranks first, as
``lax.top_k`` ranks it (``torch.topk`` promises no order).  Equal logits
give the reference's routing bit for bit.

On a mesh (DTensors) the routing, the dispatch and the combine run on each
rank's batch rows (``sharding.on_shards``): DTensor has no sharding rule
for the sorts, the searchsorted and the scatters, and a row is routed on
its own anyway.  The dispatched tokens and the expert outputs take the
placements of ("batch", "act_experts", None, None), the reference's two
constraints, and the expert products run on DTensors.

An expert share: where ``cfg.n_experts_held`` is set the layer holds the
weights of experts [``expert_first``, ``expert_first`` + held) only.  The
router keeps all ``n_experts`` outputs and its top-k; the dispatch keeps
the (token, expert) pairs routed to held experts, over the held experts
alone, and the layer returns their part of the result (what the other
experts would add is computed where they are held; no exchange runs here).
A shared expert (``cfg.d_ff_shared``, granite-4.0-h) is a SiLU-GLU every
token passes through, added to the routed experts' sum; the hybrid MoE
family's router runs in float32.

``ROUTES`` counts, by the caller's mode ("prefill", "decode", "train"),
the (token, held expert) pairs routed and the expert rows computed (held
experts x capacity x batch rows): a (2,) int64 tensor a mode and device,
summed on the device with no host synchronisation, so a replayed decode
graph keeps counting (``route_counts`` reads, ``reset_route_counts``
zeroes in place); only plain tensors on a real device are counted, not
DTensors on a mesh or the dry-run's fake and meta tensors.  A span
``moe.block`` covers each layer (``repro_torch.tracing``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import tracing
from repro_torch.distributed.sharding import (is_dtensor, on_shards,
                                              shard_activation)
from repro_torch.models.layers import _act, mlp, mlp_specs
from repro_torch.models.params import Spec

# (mode, device) -> int64 (2,): [held pairs routed, expert rows computed]
ROUTES: dict = {}


def _device_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def route_counter(mode: str, device) -> torch.Tensor:
    key = (mode, _device_key(device))
    c = ROUTES.get(key)
    if c is None:
        c = ROUTES[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return c


def route_counts(mode: str, device) -> tuple[int, int]:
    """(held pairs routed, expert rows computed) of ``mode`` on ``device``
    so far; reading them waits for the device."""
    c = ROUTES.get((mode, _device_key(device)))
    return (0, 0) if c is None else tuple(int(v) for v in c.tolist())


def reset_route_counts():
    for c in ROUTES.values():
        c.zero_()


def moe_specs(cfg) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    Eh = cfg.experts_held
    sp = {
        "w_router": Spec((d, E), ("fsdp", None)),
        "w_gate": Spec((Eh, d, ff), ("experts", "fsdp", "expert_mlp")),
        "w_up": Spec((Eh, d, ff), ("experts", "fsdp", "expert_mlp")),
        "w_down": Spec((Eh, ff, d), ("experts", "expert_mlp", "fsdp")),
    }
    if cfg.d_ff_shared:
        sp["shared"] = mlp_specs(d, cfg.d_ff_shared)
    return sp


def _capacity(tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(tokens * top_k * factor / n_experts) + 1
    return max(4, min(cap, tokens))  # floor avoids degenerate decode shapes


# XLA's float32 exp on the CPU (Cephes: exp(r) * 2^n, r = x - n ln 2 in two
# parts, a degree-7 polynomial, every step a fused multiply-add), its
# constants rounded to float32
_EXP_P = tuple(float(torch.tensor(c, dtype=torch.float32)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_LOG2E, _LN2_HI, _LN2_LO = (float(torch.tensor(c, dtype=torch.float32))
                            for c in (1.44269504088896341, -0.693359375,
                                      2.12194440e-4))


def _fma(a, b, c):
    # float32 a * b + c rounded once: the product of two float32 is exact
    # in float64
    return (a.double() * b + c).float()


def _exp_xla(z):
    n = torch.floor(_fma(z.clamp(max=88.7), _LOG2E, 0.5))
    r = _fma(n, _LN2_LO, _fma(n, _LN2_HI, z))
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = torch.ldexp(_fma(y, r * r, r) + 1.0, n)
    return torch.where(y < 2.0 ** -126, 0.0, y)      # subnormals flush to 0


def _sum_last(a):
    """Sum over the last dim, keepdim; in index order on the CPU, as XLA's
    CPU reduction adds."""
    if a.device.type != "cpu":
        return a.sum(-1, keepdim=True)
    s = a[..., :1]
    for j in range(1, a.shape[-1]):
        s = s + a[..., j:j + 1]
    return s


def route_probs(logits: torch.Tensor) -> torch.Tensor:
    """The router's f32 softmax over the last dim.  On the CPU it is XLA's
    CPU softmax op for op (its exp polynomial, sums in index order), so
    equal logits give the reference's probabilities bit for bit; on the
    card ``torch.exp`` and a tree sum, within a few ulps of those."""
    z = logits.float()
    z = z - z.amax(-1, keepdim=True)
    e = torch.exp(z) if z.device.type != "cpu" else _exp_xla(z)
    return e / _sum_last(e)


def top_k_routes(logits: torch.Tensor, top_k: int, probs=None):
    """logits (..., E) -> (weights (..., k) f32, experts (..., k) long):
    the softmax's k largest probabilities, ties to the lower expert id,
    renormalised to sum to 1.  ``probs``: ``route_probs(logits)`` if the
    caller has it."""
    probs = route_probs(logits) if probs is None else probs
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :top_k], top_e[..., :top_k]
    return top_w / _sum_last(top_w).clamp_min(1e-9), top_e


def route_and_dispatch(x_row, logits_row, top_k: int, capacity: int, E: int,
                       probs=None, held=None, counter=None):
    """x_row (S, d), logits_row (S, E) -> expert_in (E, C, d), idx (E, C)
    int32 (token S pads an empty slot), wgt (E, C) f32.  Batched: x (B, S,
    d) and logits (B, S, E) route each row on its own and give (B, E, C,
    d), (B, E, C), (B, E, C).  ``probs``: ``route_probs(logits)`` if the
    caller has it.  ``held`` (first, n): dispatch over experts [first,
    first + n) alone, the outputs' E being n; ``counter``: a (2,) int64
    tensor whose first entry gains the (token, held expert) pairs
    routed."""
    row = x_row.dim() == 2
    x = x_row[None] if row else x_row
    logits = logits_row[None] if row else logits_row
    if probs is not None and row:
        probs = probs[None]
    B, S, d = x.shape
    dev = x.device
    top_w, top_e = top_k_routes(logits, top_k, probs)        # (B, S, k)

    flat_e = top_e.reshape(B, S * top_k)
    flat_w = top_w.reshape(B, S * top_k)
    flat_tok = torch.arange(S, device=dev).repeat_interleave(top_k)

    order = torch.argsort(flat_e, dim=-1, stable=True)      # group by expert
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    st = flat_tok[order]
    # position within the expert's segment
    pos_in_e = (torch.arange(S * top_k, device=dev)
                - torch.searchsorted(se, se, side="left"))
    if held is None:
        slot = torch.where(pos_in_e < capacity, se * capacity + pos_in_e,
                           E * capacity)                    # drop sink
        if counter is not None:
            counter[0] += B * S * top_k
    else:
        first, E = held
        mine = (se >= first) & (se < first + E)
        slot = torch.where(mine & (pos_in_e < capacity),
                           (se - first) * capacity + pos_in_e, E * capacity)
        if counter is not None:
            counter[0] += mine.sum()

    idx = torch.full((B, E * capacity + 1), S, dtype=torch.int32, device=dev)
    wgt = torch.zeros((B, E * capacity + 1), dtype=torch.float32, device=dev)
    idx.scatter_(1, slot, st.to(torch.int32))
    wgt.scatter_(1, slot, sw)
    idx = idx[:, :-1].reshape(B, E, capacity)
    wgt = wgt[:, :-1].reshape(B, E, capacity)

    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=dev)[:, None, None]
    expert_in = x_pad[rows, idx.long()]                     # (B, E, C, d)
    if row:
        return expert_in[0], idx[0], wgt[0]
    return expert_in, idx, wgt


def combine(expert_out, idx, wgt, S: int):
    """expert_out (E, C, d) -> (S, d) f32 weighted scatter-add (batched:
    (B, E, C, d) -> (B, S, d)); the pad token's row S is dropped."""
    row = expert_out.dim() == 3
    if row:
        expert_out, idx, wgt = expert_out[None], idx[None], wgt[None]
    B, E, C, d = expert_out.shape
    contrib = expert_out.float() * wgt[..., None]
    out = torch.zeros((B * (S + 1), d), dtype=torch.float32,
                      device=expert_out.device)
    base = torch.arange(B, device=idx.device)[:, None] * (S + 1)
    out.index_add_(0, (idx.reshape(B, E * C).long() + base).reshape(-1),
                   contrib.reshape(B * E * C, d))
    out = out.view(B, S + 1, d)[:, :S]
    return out[0] if row else out


def moe_block(p, x, cfg, mesh=None, rules=None, mode="train"):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, the Switch load-balance
    aux loss (f32 scalar) where ``mode`` is "train", else 0.0): the held
    experts' part, plus the shared expert's output where the layer has
    one.  ``mode`` keys the ``ROUTES`` counter."""
    with tracing.span("moe.block"):
        return _moe_block(p, x, cfg, mesh, rules, mode)


def _moe_block(p, x, cfg, mesh, rules, mode):
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    Eh = cfg.experts_held
    held = (cfg.expert_first, Eh) if Eh != E else None
    cap = _capacity(S, k, E, cfg.capacity_factor)
    if cfg.family == "hybrid_moe":
        logits = x.float() @ p["w_router"].float()          # (B, S, E)
    else:
        logits = x @ p["w_router"].to(x.dtype)
    sharded = is_dtensor(x) or is_dtensor(logits)
    counter = (None if sharded or isinstance(x, FakeTensor)
               or x.device.type == "meta" else route_counter(mode, x.device))

    def route(x, logits):
        probs = route_probs(logits)
        return (*route_and_dispatch(x, logits, k, cap, E, probs, held,
                                    counter), probs)
    b = {"b": 0}
    ein, idx, wgt, probs = (on_shards(route, [x, logits], [b, b], [b] * 4)
                            if sharded else route(x, logits))
    if mesh is not None and rules is not None:
        ein = shard_activation(ein, ("batch", "act_experts", None, None),
                               rules, mesh)
    if counter is not None:
        counter[1] += B * Eh * cap
    # the expert products as batched matmuls over the held experts on (Eh,
    # B*C, .) views
    ein = ein.transpose(0, 1).reshape(Eh, B * cap, d)
    act = _act(cfg.mlp_act)
    h = act(torch.bmm(ein, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(ein, p["w_up"].to(x.dtype))
    eout = torch.bmm(h, p["w_down"].to(x.dtype))
    eout = eout.view(Eh, B, cap, d).transpose(0, 1)         # (B, Eh, C, d)
    if mesh is not None and rules is not None:
        eout = shard_activation(eout, ("batch", "act_experts", None, None),
                                rules, mesh)

    out = (on_shards(lambda e, i, w: combine(e, i, w, S), [eout, idx, wgt],
                     [b, b, b], b) if sharded else combine(eout, idx, wgt, S))

    # Switch-style load-balance aux loss, which only training reads
    aux = 0.0
    if mode == "train":
        me = probs.mean(dim=(0, 1))                         # (E,)
        top1 = torch.argmax(logits, dim=-1)
        # each expert's share of the rows' top-1 picks: integer counts
        # (exact in float32), through ops DTensor shards
        ce = (top1[..., None] == torch.arange(E, device=x.device)).to(
            torch.float32).sum(dim=(0, 1)) / (B * S)
        aux = E * torch.sum(me * ce)
    out = out.to(x.dtype)
    if cfg.d_ff_shared:
        out = out + mlp(p["shared"], x, cfg.mlp_act)
    return out, aux
