"""Architecture configs of the port — a copy of :mod:`repro.configs` for
the archs the port runs, plus the registry."""
from repro_torch.configs.base import (STANDARD_SHAPES, ModelConfig, MoESpec,
                                      ShapeSpec)
from repro_torch.configs.registry import (ARCH_IDS, all_configs, get_config,
                                          reduced_config)

__all__ = ["ModelConfig", "MoESpec", "ShapeSpec", "STANDARD_SHAPES",
           "ARCH_IDS", "all_configs", "get_config", "reduced_config"]
