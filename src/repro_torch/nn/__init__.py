"""Model stack of the port: layers, the gated MLP, the agent-sim model."""
from repro_torch.nn import agent_sim, attention, layers, mlp, module
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel

__all__ = ["agent_sim", "attention", "layers", "mlp", "module",
           "AgentSimConfig", "AgentSimModel"]
