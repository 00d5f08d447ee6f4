"""Model stack of the port: layers, MLPs, MoE, attention, blocks, the LM
and the agent-sim model."""
from repro_torch.nn import (agent_sim, attention, blocks, layers, mlp, module,
                            moe, transformer)
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
from repro_torch.nn.module import count_params
from repro_torch.nn.transformer import TransformerLM, build_model

__all__ = ["agent_sim", "attention", "blocks", "layers", "mlp", "module",
           "moe", "transformer", "AgentSimConfig", "AgentSimModel", "count_params",
           "TransformerLM", "build_model"]
