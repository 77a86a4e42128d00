"""The bytes and operations of the Mamba-2 chunk scan (``ssd_scan``'s
tensor-core path: four launches a call, C.B^T, the chunk states, their
ordered hand-off, y), for the inputs it is handed.

Bytes: each input read once and each output written once: x (B, S, H, P)
and y in x's dtype, B and C (B, S, N) in x's dtype, dt (B, S, H) float32,
A and D (H,) float32, the final state (B, H, N, P) float32 written, an
initial state read where one is given.  Operations, the products a
multiply-add two, n_groups 1 (B and C shared by the heads), L the chunk,
per chunk of every row: C.B^T over the causal pairs, L (L + 1) N; per
chunk and head: the causal intra-chunk product with x, L (L + 1) P; the
chunk's own state, 2 L N P; the output from the state entering it, 2 L N
P; the hand-off, 2 N P.  S is what the kernel is handed (a prompt padded
to a chunk multiple).  ``per_kernel`` splits a call's counts evenly over
its four launches, each of which the trace matches on its own.
"""
from __future__ import annotations

KERNELS_PER_CALL = 4


def ssd_scan_counts(S: int, *, B: int = 1, H: int, P: int, N: int,
                    chunk: int, x_bytes: int = 2,
                    h0: bool = False) -> tuple[int, int]:
    """(bytes, operations) of one chunk-scan call over B rows of S
    tokens (S a multiple of ``chunk``)."""
    L, nc = chunk, S // chunk
    nbytes = (B * S * (2 * H * P * x_bytes + 2 * N * x_bytes + 4 * H)
              + 2 * 4 * H + B * H * N * P * 4 * (2 if h0 else 1))
    per_chunk = L * (L + 1) * N + H * (L * (L + 1) * P + 4 * L * N * P
                                       + 2 * N * P)
    return nbytes, B * nc * per_chunk


def per_kernel(counts: tuple[int, int]) -> tuple[float, float]:
    """A call's (bytes, operations) split over its four launches."""
    return counts[0] / KERNELS_PER_CALL, counts[1] / KERNELS_PER_CALL
