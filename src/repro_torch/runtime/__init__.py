"""Runtime: the closed-loop rollout engine and the evaluation over it."""
from repro_torch.runtime.evaluation import (EvalConfig, evaluate_families,
                                            evaluate_scenes)
from repro_torch.runtime.rollout import RolloutEngine

__all__ = ["RolloutEngine", "EvalConfig", "evaluate_families",
           "evaluate_scenes"]
