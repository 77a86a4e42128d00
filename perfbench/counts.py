"""The yardstick's arithmetic: the bytes and operations each measured kernel
needs for the inputs it was handed, the chip's published peaks, and the
model FLOPs behind the utilisation metrics.

Every count follows the range the kernel itself computes from its inputs
(where the work depends on the data, count what these inputs need, not the
most they could):

* decode attention reads, for each of the B rows it is handed, the cache
  rows ``[max(0, kv_valid - window), min(kv_valid, S))`` of every kv head
  (``csrc/decode_attention.cu``: ``lo``, ``hi``), K and V, plus q once and o
  once;
* flash attention over a causal prompt computes, for query i, the keys
  ``max(0, i - window + 1) .. i``: ``min(i + 1, window)`` pairs a head;
* the stacked LSTM forecast reads each target's weights once, its window
  once and writes its output once.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assume the card's full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


# ------------------------------------------------------ decode attention --
def decode_visible_rows(kv_valid: int, S: int, window: int | None) -> int:
    """Cache rows the decode kernel reads for one row handed to it."""
    hi = min(kv_valid, S)
    lo = max(0, kv_valid - window) if window else 0
    return max(0, hi - lo)


def decode_attention_bytes(kv_valid, *, S: int, window: int | None, Hq: int,
                           Hkv: int, D: int, kv_bytes: int = 2,
                           q_bytes: int = 2) -> int:
    """Bytes one decode launch needs: every row's visible K and V rows of
    every kv head, q read once and o written once (in q's dtype)."""
    rows = sum(decode_visible_rows(int(v), S, window) for v in kv_valid)
    B = len(kv_valid)
    return Hkv * rows * D * 2 * kv_bytes + 2 * B * Hq * D * q_bytes


def decode_attention_flops(kv_valid, *, S: int, window: int | None,
                           Hq: int, D: int) -> int:
    """Scores and the weighted sum: 4 D operations a query head and row."""
    rows = sum(decode_visible_rows(int(v), S, window) for v in kv_valid)
    return 4 * Hq * D * rows


# ------------------------------------------------------- flash attention --
def causal_pairs(S: int, window: int | None) -> int:
    """Query-key pairs a head of a causal prompt of S tokens computes:
    sum over i of min(i + 1, window)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    w = window
    return w * (w + 1) // 2 + (S - w) * w


def flash_prefill_counts(S: int, *, B: int = 1, Hq: int, Hkv: int, D: int,
                         window: int | None, elt: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one causal flash launch over B prompts of S
    tokens: q, k, v read once, o written once; 4 D operations a pair and
    query head."""
    nbytes = B * S * D * elt * (2 * Hq + 2 * Hkv)
    ops = 4 * B * Hq * D * causal_pairs(S, window)
    return nbytes, ops


# ------------------------------------------------------ the stacked LSTM --
def lstm_stacked_counts(Z: int, W: int, M: int, H: int,
                        n_out: int) -> tuple[int, int]:
    """(bytes, operations) of one stacked forecast of Z targets, each with
    its own weights: the weights (Wx, Wh where W > 1, b, Wo, bo) read once,
    the (Z, W, M) windows read once, the (Z, n_out) outputs written once,
    all float32.  Operations a target: the input and recurrent products
    (2 a multiply-add; h(-1) = 0, so step 0 has no recurrent product), the
    gates and cell (23 H a step, 17 H at step 0), the ReLU and the head."""
    w_floats = (M + (H if W > 1 else 0) + 1) * 4 * H + (H + 1) * n_out
    nbytes = 4 * (Z * w_floats + Z * W * M + Z * n_out)
    per_target = (W * 2 * M * 4 * H + (W - 1) * 2 * H * 4 * H
                  + (W - 1) * 23 * H + 17 * H
                  + H + 2 * H * n_out + n_out)
    return nbytes, Z * per_target


# ------------------------------------------------------- roofline shares --
def roofline_pct(nbytes: float, ops: float, device_s: float,
                 flop_rate: float = BF16_FLOP_PER_S) -> float | None:
    """The least time the chip could take (the larger of the bytes over
    HBM bandwidth and the operations over the peak rate) over the device
    time, in percent; None where nothing was timed."""
    if device_s <= 0:
        return None
    least = max(nbytes / HBM_BYTES_PER_S, ops / flop_rate)
    return 100.0 * least / device_s


# ------------------------------------------------------------ the decoder --
def decoder_params(c: dict) -> dict:
    """Parameter counts of a dense decoder from its published widths
    (vocabulary tables padded to a multiple of 2048, as the program holds
    them): {"layers", "embedding", "head", "head_true", "final_norm",
    "total"}."""
    d, Hq, Hkv, D = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    ff, V = c["d_ff"], c["vocab"]
    pv = -(-V // 2048) * 2048
    attn = d * Hq * D * 2 + d * Hkv * D * 2
    mlp = 3 * d * ff
    layer = attn + mlp + 2 * d
    out = {"layers": c["n_layers"] * layer, "embedding": pv * d,
           "head": pv * d, "head_true": V * d, "final_norm": d}
    out["total"] = (out["layers"] + out["embedding"] + out["head"]
                    + out["final_norm"])
    return out


def decode_model_flops(c: dict, kv_valid_active) -> int:
    """Model FLOPs of one decode step: per active slot, 2 x the parameters
    its token multiplies (the layers and the head over the true
    vocabulary; the embedding is a gather) plus 4 Hq D times the rows its
    query sees in each layer, windowed."""
    p = decoder_params(c)
    n_mult = p["layers"] + p["head_true"]
    per_layer = 4 * c["n_heads"] * c["head_dim"]
    w = c.get("sliding_window")
    rows = sum(min(int(v), w) if w else int(v) for v in kv_valid_active)
    return 2 * n_mult * len(kv_valid_active) + c["n_layers"] * per_layer * rows


def train_model_flops(c: dict, tokens: int) -> int:
    """6 N tokens, N every parameter the program holds (padded vocabulary
    tables included); attention-score FLOPs are not counted."""
    return 6 * decoder_params(c)["total"] * tokens
