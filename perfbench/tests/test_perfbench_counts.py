"""The yardstick's counts against hand arithmetic, plain loops over each
kernel's own range, and the bounds of PERF.md's kernel table; the rule that
matches a traced kernel's device events to its launches."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import counts
from perfbench.trace import Unit, reduce_trace

S, WINDOW, HQ, HKV, D = 8192, 4096, 32, 8, 80


def loop_rows(kv_valid, S, window):
    """Rows the decode kernel reads for one row: a plain loop over the
    cache positions it visits, [max(0, v - window), min(v, S))."""
    lo = max(0, kv_valid - window) if window else 0
    return sum(1 for _ in range(lo, min(kv_valid, S)))


@pytest.mark.parametrize("kv_valid, rows", [(1, 1), (4096, 4096),
                                            (4097, 4096), (8192, 4096),
                                            (9000, 3288)])
def test_decode_rows_windowed(kv_valid, rows):
    assert counts.decode_visible_rows(kv_valid, S, WINDOW) == rows
    assert loop_rows(kv_valid, S, WINDOW) == rows


@pytest.mark.parametrize("kv_valid, rows", [(1, 1), (4097, 4097),
                                            (8192, 8192), (9000, 8192)])
def test_decode_rows_without_window(kv_valid, rows):
    assert counts.decode_visible_rows(kv_valid, S, None) == rows
    assert loop_rows(kv_valid, S, None) == rows


def test_decode_bytes_by_hand():
    kv = [1, 4096, 4097, 8192, 9000]
    rows = 1 + 4096 + 4096 + 4096 + 3288
    want = HKV * rows * D * 2 * 2 + 2 * len(kv) * HQ * D * 2
    assert counts.decode_attention_bytes(kv, S=S, window=WINDOW, Hq=HQ,
                                         Hkv=HKV, D=D) == want
    # a count over every valid row instead of the visible ones overstates
    # the bytes read past the window by their ratio
    valid_rows = sum(min(v, S) for v in kv)
    assert valid_rows > rows


def test_decode_bytes_match_perf_table_bound():
    """PERF.md row 8: B=16, kv_valid linspace(1, 8192, 16), 48,064 visible
    rows a kv head, bound 0.0368 ms."""
    kv = np.linspace(1, S, 16).round().astype(int)
    assert sum(counts.decode_visible_rows(int(v), S, WINDOW)
               for v in kv) == 48_064
    nbytes = counts.decode_attention_bytes(kv, S=S, window=WINDOW, Hq=HQ,
                                           Hkv=HKV, D=D)
    assert round(nbytes / counts.HBM_BYTES_PER_S * 1e3, 4) == 0.0368


def loop_pairs(Sq, window):
    """(query, key) pairs of a causal prompt: a plain double loop."""
    return sum(1 for i in range(Sq) for j in range(i + 1)
               if window is None or i - j < window)


@pytest.mark.parametrize("Sq, window", [(1, 4), (7, 4), (64, 16),
                                        (100, 100), (50, None), (96, 200)])
def test_causal_pairs_against_a_loop(Sq, window):
    assert counts.causal_pairs(Sq, window) == loop_pairs(Sq, window)


def test_flash_pairs_at_6144_with_the_window():
    assert counts.causal_pairs(6144, 4096) == 16_779_264
    assert counts.causal_pairs(6144, None) == 18_877_440
    nbytes, ops = counts.flash_prefill_counts(6144, Hq=HQ, Hkv=HKV, D=D,
                                              window=WINDOW)
    assert ops == 4 * HQ * D * 16_779_264
    assert nbytes == 6144 * D * 2 * (2 * HQ + 2 * HKV)
    # PERF.md row 7's bound at 6144 tokens: 0.1737 ms (operations)
    assert round(ops / counts.BF16_FLOP_PER_S * 1e3, 4) == 0.1737


def test_lstm_stacked_bytes_match_perf_table_bound():
    """PERF.md row 2: Z=4096, W=4, M=5, H=50, bound 0.0561 ms (bytes)."""
    nbytes, ops = counts.lstm_stacked_counts(4096, 4, 5, 50, 5)
    assert round(nbytes / counts.HBM_BYTES_PER_S * 1e3, 4) == 0.0561
    assert nbytes / counts.HBM_BYTES_PER_S > ops / counts.F32_FLOP_PER_S


def test_danube_parameter_count():
    c = dict(n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
             head_dim=80, d_ff=6912, vocab=32000)
    assert counts.decoder_params(c)["total"] == 1_835_133_440


def test_roofline_share_is_not_capped():
    # twice the work the time allows reads 200%: nothing hides it
    t = 1e9 / counts.HBM_BYTES_PER_S
    assert counts.roofline_pct(2e9, 0, t) == pytest.approx(200.0)
    assert counts.roofline_pct(1e9, 0, 0.0) is None


def _unit(kind, i, t0, t1, nbytes):
    u = Unit(kind, i, {"k": (nbytes, 0)}, {"k": 2})
    u.start_us, u.end_us = t0, t1
    return u


def test_bytes_and_time_cover_the_same_launches():
    """Two units of two launches each, with different bytes a launch; the
    profiler dropped one launch of the second unit.  The share sums bytes
    only over recorded launches, each matched to its own unit: a count of
    every launch's bytes over the recorded time would read too high."""
    units = [_unit("step", 0, 0.0, 100.0, 1000),
             _unit("step", 1, 200.0, 300.0, 5000)]
    dev = [("k_kernel", 10.0, 20.0), ("k_kernel", 30.0, 40.0),
           ("k_kernel", 210.0, 260.0), ("memcpy", 270.0, 280.0)]
    out = reduce_trace(units, dev, [], {"k": "k_kernel"}, (0.0, 300.0))
    k = out["kernels"]["k"]
    assert (k.counted, k.recorded, k.matched) == (4, 3, 3)
    assert k.bytes == 1000 + 1000 + 5000
    assert k.device_s == pytest.approx((10 + 10 + 50) / 1e6)
    all_bytes = 2 * 1000 + 2 * 5000
    assert all_bytes / k.device_s > k.bytes / k.device_s
    assert out["busy_s"] == pytest.approx(80 / 1e6)
    assert out["unit_events"] == {"step": 4}
    assert out["unit_busy_s"]["step"] == pytest.approx(80 / 1e6)


def test_an_event_outside_every_unit_is_not_matched():
    units = [_unit("step", 0, 0.0, 100.0, 1000)]
    dev = [("k_kernel", 10.0, 20.0), ("k_kernel", 150.0, 160.0)]
    out = reduce_trace(units, dev, [("host_op", 100.0, 200.0)],
                       {"k": "k_kernel"}, (0.0, 200.0))
    k = out["kernels"]["k"]
    assert (k.recorded, k.matched, k.bytes) == (2, 1, 1000)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["host_op"] == pytest.approx(40 / 1e6)


def test_a_dropped_launch_is_added_back_to_the_card_time():
    """A device-only trace of three counted launches in which the profiler
    recorded two: the window's busy time gets the missing one at the
    recorded ones' mean, so a lost event does not read as a faster tick;
    a trace that recorded none, or more than were counted, fails."""
    from perfbench.harness import REPO, load_module
    plane = load_module(REPO / "perfbench" / "loops" / "plane_ticks.py",
                        "perfbench_loop_plane_ticks")
    dev = [("k_kernel", 0.0, 10.0), ("memcpy", 10.0, 12.0),
           ("k_kernel", 20.0, 50.0)]
    out = reduce_trace([], dev, [], {"k": "k_kernel"}, (0.0, 60.0))
    k = out["kernels"]["k"]
    assert (k.recorded, k.recorded_s) == (2, pytest.approx(40 / 1e6))
    assert out["busy_s"] == pytest.approx(42 / 1e6)
    assert plane.card_busy_s(out, "k", 2) == pytest.approx(42 / 1e6)
    assert plane.card_busy_s(out, "k", 3) == pytest.approx(62 / 1e6)
    with pytest.raises(RuntimeError):
        plane.card_busy_s(out, "k", 1)
    none = reduce_trace([], [("memcpy", 0.0, 1.0)], [], {"k": "k_kernel"},
                        (0.0, 2.0))
    with pytest.raises(RuntimeError):
        plane.card_busy_s(none, "k", 3)
