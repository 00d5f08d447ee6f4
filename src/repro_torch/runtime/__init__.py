"""Runtime: the closed-loop rollout engine."""
from repro_torch.runtime.rollout import RolloutEngine

__all__ = ["RolloutEngine"]
