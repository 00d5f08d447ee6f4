"""Agent-simulation architectures (port of ``repro/configs/base.py:193-247``
and the ``sim-*`` rows of ``repro/configs/archs.py``).

One arch per Table-I attention mechanism, identical everywhere else
(``absolute`` adds its pose embedding's projection). The four names are
the reference's, and each builds a model in the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.nn.agent_sim import AgentSimConfig
from repro_torch.scenarios.core import ScenarioConfig


@dataclasses.dataclass(frozen=True)
class SimArch:
    """Scene-transformer hyperparameters paired with the ScenarioConfig
    whose action grid it predicts."""
    name: str
    encoding: str                 # absolute | rope2d | se2_repr | se2_fourier
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 8
    head_dim: int = 24
    d_ff: int = 1024
    fourier_terms: int = 12
    pos_scale: float = 0.05
    num_map: int = 48
    num_agents: int = 12
    num_steps: int = 24
    dtype: str = "float32"
    notes: str = ""

    def scenario_config(self) -> ScenarioConfig:
        return ScenarioConfig(num_map=self.num_map,
                              num_agents=self.num_agents,
                              num_steps=self.num_steps)

    def agent_sim_config(self) -> AgentSimConfig:
        scen = self.scenario_config()
        return AgentSimConfig(
            d_model=self.d_model, num_layers=self.num_layers,
            num_heads=self.num_heads, head_dim=self.head_dim,
            d_ff=self.d_ff, num_actions=scen.num_actions,
            agent_feat_dim=scen.agent_feat_dim,
            map_feat_dim=scen.map_feat_dim,
            encoding=self.encoding, fourier_terms=self.fourier_terms,
            pos_scale=self.pos_scale, dtype=self.dtype)

    def reduced(self, **overrides) -> "SimArch":
        """CPU-sized same-encoding config."""
        small: Dict = dict(d_model=64, num_layers=2, num_heads=4,
                           head_dim=24, d_ff=256,
                           num_map=16, num_agents=6, num_steps=10,
                           dtype="float32")
        small.update(overrides)
        return dataclasses.replace(self, **small)


_NOTES = {
    "absolute": "non-invariant baseline: learned Fourier pose embedding "
                "added to token features",
    "rope2d": "translation-invariant only (paper Sec. II-D)",
    "se2_repr": "exact SE(2) invariance via homogeneous-matrix "
                "representation (Sec. II-E)",
    "se2_fourier": "the paper's linear-memory SE(2) encoding (Sec. III)",
}

SIM_ARCHS: Dict[str, SimArch] = {
    f"sim-{enc.replace('_', '-')}": SimArch(
        name=f"sim-{enc.replace('_', '-')}", encoding=enc, notes=note)
    for enc, note in _NOTES.items()
}


def get_sim_arch(name: str) -> SimArch:
    if name not in SIM_ARCHS:
        raise KeyError(f"unknown sim arch {name!r}; have {sorted(SIM_ARCHS)}")
    return SIM_ARCHS[name]
