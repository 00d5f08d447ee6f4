"""Architecture configs and shapes (port of ``repro/configs``). Importing
the package registers the ten LM architectures and the four sim archs."""
from repro_torch.configs import archs  # noqa: F401  (registers the archs)
from repro_torch.configs.base import (SHAPES, SIM_ARCHS, MLAConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SimArch, SSMConfig, all_configs,
                                      get_config, get_sim_arch, register,
                                      register_sim)

ARCH_NAMES = sorted(all_configs())
SIM_ARCH_NAMES = sorted(SIM_ARCHS)

__all__ = ["SHAPES", "SIM_ARCHS", "MLAConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "SimArch", "SSMConfig", "all_configs",
           "get_config", "get_sim_arch", "register", "register_sim",
           "ARCH_NAMES", "SIM_ARCH_NAMES"]
