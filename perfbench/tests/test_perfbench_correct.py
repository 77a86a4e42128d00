"""The checks that decide ``correct``, on the CPU at test sizes: a sound run
of each test cell comes out correct; the control (the plain reference one
precision below the configuration's, in the program's place) reads above
the cell's limits; and a run whose timed path is broken underneath, once
for each fault its cell can have, comes out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import execute
from perfbench.tests.tinyroot import cpu_run, make_root

CELLS = ("tiny-lstm.steady", "tiny-danube.chat", "tiny-danube.train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("perfbench"))


def go(root, cell, seed=11, seconds=1.5, control=False):
    run = cpu_run(root, cell, seed=seed, seconds=seconds)
    run.control = control
    return run, execute(run)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7, 2 ** 33 + 1])
def test_a_sound_run_is_correct_and_its_control_is_not(root, cell, seed):
    run, out = go(root, cell, seed=seed, control=True)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    low = run.record["control"]
    assert set(low) == set(run.compared)
    assert any(v > run.cell.limits[k] for k, v in low.items()), low


# ------------------------------------------------------------- faults ----
def plane_unchanged(mp):
    """The step returns its state unchanged: the ring never takes a row."""
    from repro_torch.core.device_plane import DevicePlaneEngine
    mp.setattr(DevicePlaneEngine, "push_rows", lambda self, rows: None)


def plane_half(mp):
    """Half of the batch left out: the second half of the targets get no
    forecast."""
    from repro_torch.core.device_plane import DevicePlaneEngine
    orig = DevicePlaneEngine.forward

    def forward(self, ring_ref):
        out = orig(self, ring_ref).copy()
        out[len(out) // 2:] = np.nan
        return out
    mp.setattr(DevicePlaneEngine, "forward", forward)


def plane_altered(mp):
    """An answer altered where it is produced: one target's forecast."""
    from repro_torch.core.device_plane import DevicePlaneEngine
    orig = DevicePlaneEngine.forward

    def forward(self, ring_ref):
        out = orig(self, ring_ref).copy()
        out[3] *= 1.01
        return out
    mp.setattr(DevicePlaneEngine, "forward", forward)


def serve_unchanged(mp):
    """The step returns its state unchanged: the cache lengths do not
    advance, so every step decodes at the same position."""
    from repro_torch.models.transformer import DecoderLM
    orig = DecoderLM.decode_step

    def decode_step(self, params, cache, tokens, **kw):
        lens = {k: c["len"].clone() for k, c in cache.items() if "len" in c}
        logits, cache = orig(self, params, cache, tokens, **kw)
        for k, v in lens.items():
            cache[k]["len"].copy_(v)
        return logits, cache
    mp.setattr(DecoderLM, "decode_step", decode_step)


def serve_half(mp):
    """Half of the batch left out: the second half of the slots are fed a
    constant token instead of their own."""
    from repro_torch.models.transformer import DecoderLM
    orig = DecoderLM.decode_step

    def decode_step(self, params, cache, tokens, **kw):
        tokens = tokens.clone()
        tokens[tokens.shape[0] // 2:] = 0
        return orig(self, params, cache, tokens, **kw)
    mp.setattr(DecoderLM, "decode_step", decode_step)


def serve_altered(mp):
    """A token altered where it is produced: every third step's tokens
    moved to the next vocabulary entry."""
    from repro_torch.serving.engine import DecodeEngine
    orig = DecodeEngine._select_token
    n = {"calls": 0}

    def select(self, logits):
        out = orig(self, logits)
        n["calls"] += 1
        return (out + 1) % self.cfg.vocab if n["calls"] % 3 == 0 else out
    mp.setattr(DecodeEngine, "_select_token", select)


def train_unchanged(mp):
    """The step returns its state unchanged: AdamW updates nothing."""
    import repro_torch.launch.steps as steps
    mp.setattr(steps, "adamw_update_",
               lambda grads, state, params, c: (params, state, {
                   "lr": torch.zeros(()), "grad_norm": torch.zeros(())}))


def train_half(mp):
    """Half of the batch left out: the loss is the mean over the first
    half of the rows."""
    from repro_torch.models.transformer import DecoderLM
    orig = DecoderLM.loss

    def loss(self, params, batch, **kw):
        h = batch["tokens"].shape[0] // 2
        return orig(self, params, {k: v[:h] for k, v in batch.items()}, **kw)
    mp.setattr(DecoderLM, "loss", loss)


FAULTS = [("tiny-lstm.steady", plane_unchanged),
          ("tiny-lstm.steady", plane_half),
          ("tiny-lstm.steady", plane_altered),
          ("tiny-danube.chat", serve_unchanged),
          ("tiny-danube.chat", serve_half),
          ("tiny-danube.chat", serve_altered),
          ("tiny-danube.train", train_unchanged),
          ("tiny-danube.train", train_half)]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f.__name__ for _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    _, out = go(root, cell)
    assert not out["correct"], out["compared"]
