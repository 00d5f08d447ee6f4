"""Behaviour-cloning training of the agent-sim model (port of
``repro/training``: the expert data and the train / eval steps)."""
from repro_torch.training import data, steps

__all__ = ["data", "steps"]
