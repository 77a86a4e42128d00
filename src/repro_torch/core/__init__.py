# The paper's primary contribution, ported: the Proactive Pod Autoscaler and
# its substrate -- the forecaster zoo (LSTM, attention, ARMA / ARIMA, the
# deep ensemble), Evaluator (Alg. 1), static policies, Updater (3 update
# policies), the batched FleetController, the sharded control plane and the
# reactive HPA baseline (Eq. 1).
from repro_torch.core.metrics import (METRIC_NAMES, N_METRICS, KEY_CPU,
                                      KEY_CUSTOM, MetricsHistory, Snapshot)
from repro_torch.core.forecaster import (Forecaster, LSTMForecaster,
                                         AttnLSTMForecaster,
                                         ARMAForecaster, ARIMAD1Forecaster,
                                         EnsembleForecaster, make_forecaster)
from repro_torch.core.policies import (ThresholdPolicy,
                                       TargetUtilizationPolicy, SLAPolicy,
                                       GuardrailConfig, ResilienceConfig,
                                       make_policy, policy_vectorizable)
from repro_torch.core.evaluator import Evaluator, EvalResult
from repro_torch.core.updater import Updater, UpdatePolicy
from repro_torch.core.hpa import HPA
from repro_torch.core.ppa import PPA, PPAConfig, ScaleDownStabilizer
from repro_torch.core.controller import FleetController, TargetSpec
from repro_torch.core.control_plane import (ShardedControlPlane, Tick,
                                            TickResult, Guardrail,
                                            shard_assignment, stage_collect,
                                            stage_formulate, stage_forecast,
                                            stage_evaluate, stage_degrade,
                                            stage_guard, stage_actuate)
