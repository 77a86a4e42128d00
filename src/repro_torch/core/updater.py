"""The Updater and its three model-update policies (paper §4.2.3):

  P1 NEVER     — keep the injected seed model for the whole run.
  P2 SCRATCH   — drop the old model each update loop, retrain from scratch
                 (same architecture) on the accumulated history.
  P3 FINETUNE  — continue training the old model for a few extra epochs on
                 the history collected since the last update.

After an update the Updater re-saves the model file and clears the metrics
history, exactly as in the paper's workflow (§4.1.2).

Beyond the paper's single-target loop, ``update_batch`` refits a whole
fleet of per-target models: homogeneous stacked LSTMs go through ONE
vmapped dispatch (``lstm_fit_batch_stacked``), heterogeneous model sets
fall back to sequential fits with identical bookkeeping.  The
``begin_update_batch`` / ``_PendingUpdate`` split lets the sharded control
plane run the compute phase on a worker thread off the tick critical path
(DESIGN.md §5).  ``model_path`` may be a per-target template containing
``{target}`` so Z targets persist to Z files instead of overwriting one.
"""
from __future__ import annotations

import enum
import time

from repro_torch.core.forecaster import Forecaster, lstm_fit_batch_stacked
from repro_torch.core.metrics import MetricsHistory


class UpdatePolicy(enum.Enum):
    NEVER = 1
    SCRATCH = 2
    FINETUNE = 3


class Updater:
    def __init__(self, policy: UpdatePolicy, model_path=None,
                 min_records: int = 16):
        self.policy = policy
        self.model_path = model_path
        self.min_records = min_records
        self.n_updates = 0
        self.last_update_t: float | None = None

    # ------------------------------------------------------------- paths --
    def path_for(self, target: str | None = None):
        """Resolve the save path for one target.  ``model_path`` may be a
        per-target template with a ``{target}`` placeholder, so per-target
        persistence writes Z files instead of Z targets overwriting one."""
        if not self.model_path:
            return None
        path = str(self.model_path)
        if "{target}" in path:
            if target is None:
                # a template only makes sense on the per-target path; a
                # silent 'None' filename would look like a good save
                raise ValueError("model_path template requires a target "
                                 "name (update(..., target=...))")
            return path.format(target=target)
        return path

    # ------------------------------------------------------ single target --
    def update(self, model: Forecaster, history: MetricsHistory,
               t: float | None = None, target: str | None = None
               ) -> Forecaster:
        if self.policy is UpdatePolicy.NEVER:
            history.clear()
            return model
        series = history.series()
        if len(series) < self.min_records:
            return model
        model.fit(series, from_scratch=(self.policy is UpdatePolicy.SCRATCH))
        if self.model_path:
            model.save(self.path_for(target))
        history.clear()
        self.n_updates += 1
        self.last_update_t = t if t is not None else time.time()
        return model

    # ------------------------------------------------------------ batched --
    def begin_update_batch(self, models: list[Forecaster],
                           histories: list[MetricsHistory],
                           t: float | None = None,
                           targets: list[str] | None = None):
        """Snapshot phase of a batched update: applies the policy gates,
        snapshots each eligible history's series and clears it (so samples
        arriving while the refit is in flight accumulate for the *next*
        cycle), and returns a ``_PendingUpdate`` — or ``None`` when nothing
        is due.  ``pending.compute()`` is thread-safe (mutates no model);
        ``pending.commit()`` installs the result and must run on the
        control thread."""
        if self.policy is UpdatePolicy.NEVER:
            for h in histories:
                h.clear()
            return None
        serieses = [h.series() for h in histories]
        idx = [i for i, s in enumerate(serieses)
               if len(s) >= self.min_records]
        if not idx:
            return None
        for i in idx:
            histories[i].clear()
        return _PendingUpdate(
            self, [models[i] for i in idx], [serieses[i] for i in idx],
            [targets[i] if targets else None for i in idx], t)

    def update_batch(self, models: list[Forecaster],
                     histories: list[MetricsHistory],
                     t: float | None = None,
                     targets: list[str] | None = None) -> list[Forecaster]:
        """Synchronous batched ``update``: P2/P3 refits of all eligible
        targets in one vmapped dispatch when the models stack, sequential
        fits otherwise.  Models are updated in place and returned."""
        pending = self.begin_update_batch(models, histories, t, targets)
        if pending is not None:
            pending.compute()
            pending.commit()
        return models


class _PendingUpdate:
    """A batched model update split into ``compute`` (worker-thread-safe:
    reads model params/scalers, mutates nothing) and ``commit`` (installs
    new params, saves, bumps counters — control thread only)."""

    def __init__(self, updater: Updater, models, serieses, targets, t):
        self.updater = updater
        self.models = models
        self.serieses = serieses
        self.targets = targets
        self.t = t
        self.from_scratch = updater.policy is UpdatePolicy.SCRATCH
        self.batched: bool | None = None   # set by compute()
        self._fit = None

    def compute(self):
        self._fit = lstm_fit_batch_stacked(
            self.models, self.serieses, self.from_scratch, apply=False)
        self.batched = self._fit is not None
        if self._fit is not None:
            self._fit.block_until_ready()
        return self

    def commit(self):
        if self.batched is None:
            self.compute()
        if self._fit is not None:
            self._fit.apply()
        else:
            # non-stackable (heterogeneous archs / unequal histories):
            # sequential fits, identical bookkeeping
            for m, s in zip(self.models, self.serieses):
                m.fit(s, from_scratch=self.from_scratch)
        u = self.updater
        if u.model_path:
            for m, tgt in zip(self.models, self.targets):
                m.save(u.path_for(tgt))
        u.n_updates += len(self.models)
        u.last_update_t = self.t if self.t is not None else time.time()
        return self.models
