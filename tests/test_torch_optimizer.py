"""The port's AdamW against the JAX package's, step for step.

Identical numpy params and gradients go through 10 ``adamw_update`` steps
in both packages.  Both compute in float32 with the same op order, so the
params agree to rounding: 1e-6 relative, 1e-7 absolute.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)

# the forecaster's config (core/forecaster.py) and the defaults (warmup,
# cosine decay, weight decay, global-norm clipping)
CONFIGS = {
    "forecaster": dict(lr=1e-2, weight_decay=0.0, clip_norm=None,
                       warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0),
    "defaults": dict(lr=3e-2, warmup_steps=3, total_steps=8),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_adamw_ten_steps_match_jax(name):
    kw = CONFIGS[name]
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.b2, tc.eps) == (0.95, 1e-8)
    rng = np.random.default_rng(0)
    shapes = {"Wx": (5, 200), "Wh": (50, 200), "b": (200,), "Wo": (50, 5),
              "bo": (5,)}
    params = {k: rng.normal(0, 0.3, s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.adamw_init(jp, jc), topt.adamw_init(tp, tc)
    for step in range(10):
        grads = {k: rng.normal(0, 1.0 + step, s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jinfo = jopt.adamw_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, js, jp, jc)
        tp, ts, tinfo = topt.adamw_update(
            {k: torch.tensor(g) for k, g in grads.items()}, ts, tp, tc)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 10
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["mu"][k].numpy(),
                                   np.asarray(js["mu"][k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["nu"][k].numpy(),
                                   np.asarray(js["nu"][k]),
                                   rtol=1e-6, atol=1e-7)


def test_schedule_matches_jax():
    c = dict(lr=1.0, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jopt.schedule(jopt.AdamWConfig(**c),
                                    jnp.asarray(steps)))
    got = topt.schedule(topt.AdamWConfig(**c), torch.tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
