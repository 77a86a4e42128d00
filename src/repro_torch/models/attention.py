"""Attention for the decoder: GQA with causal / sliding-window / soft-cap
variants, on the hand-written kernels.

The JAX package's ``models/attention.py`` has three implementations of one
function (``naive``, ``blocked`` in pure JAX, ``pallas``).  In the port all
three go to ``kernels/flash_attention.py`` -- the CUDA kernel for CUDA
tensors, its plain version for CPU tensors -- and ``decode_attention``
goes to ``kernels/decode_attention.py``.  The model's layout stays the JAX
package's, q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); the kernels get
(B, H, S, D) views of the same memory (the reference's ``pallas`` path
handed its kernel the wrong layout, ROADMAP.md section 3; the port does
not).
"""
from __future__ import annotations

from repro_torch.distributed.sharding import is_dtensor, on_shards
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel

IMPLS = ("naive", "blocked", "pallas")


def attention(q, k, v, *, impl="blocked", causal=True, window=None,
              cap=None, q_offset=0, kv_valid=None, scale=None, block_q=None,
              block_kv=None):
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).  Every
    ``impl`` computes the same function on the flash kernel; the JAX
    package's block sizes are accepted and have no effect.  DTensors run
    the kernel on their local batch rows and heads (``on_shards``), the
    sequences and D whole."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")

    def flash(q, k, v):
        return flash_kernel.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, cap=cap, q_offset=q_offset,
            kv_valid=kv_valid, scale=scale).transpose(1, 2)
    if not any(is_dtensor(t) for t in (q, k, v)):
        return flash(q, k, v)
    bh = {"b": 0, "h": 2}
    return on_shards(flash, [q, k, v], [bh, bh, bh], bh)


def decode_attention(q, k_cache, v_cache, *, kv_valid, window=None, cap=None,
                     scale=None):
    """One decode token against a cache: q (B, 1, Hq, D); k_cache, v_cache
    (B, S, Hkv, D); kv_valid (B,) valid cache entries (the query sits at
    kv_valid - 1) -> (B, 1, Hq, D) in q's dtype.  The kernel reads the
    cache through (B, Hkv, S, D) views, where it lies; DTensors run it on
    their local batch rows and heads, the cache's rows whole."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention takes one query a row, got "
                         f"{q.shape[1]}")

    def decode(q, k_cache, v_cache, kv_valid):
        return decode_kernel.decode_attention(
            q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            kv_valid=kv_valid, cap=cap, window=window, scale=scale)[:, None]
    if not any(is_dtensor(t) for t in (q, k_cache, v_cache, kv_valid)):
        return decode(q, k_cache, v_cache, kv_valid)
    bh = {"b": 0, "h": 2}
    return on_shards(decode, [q, k_cache, v_cache, kv_valid],
                     [bh, bh, bh, {"b": 0}], bh)
