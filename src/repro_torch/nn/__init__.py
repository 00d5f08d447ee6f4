"""Model stack of the port: layers, MLPs, MoE, the SSM mixers, attention,
blocks, the LMs (decoder-only and encoder-decoder) and the agent-sim
model."""
from repro_torch.nn import (agent_sim, attention, blocks, layers, mlp, module,
                            moe, ssm, transformer)
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
from repro_torch.nn.module import count_params
from repro_torch.nn.transformer import EncDecLM, TransformerLM, build_model

__all__ = ["agent_sim", "attention", "blocks", "layers", "mlp", "module",
           "moe", "ssm", "transformer", "AgentSimConfig", "AgentSimModel",
           "count_params", "EncDecLM", "TransformerLM", "build_model"]
