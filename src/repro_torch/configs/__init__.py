from .base import (ModelConfig, MoEConfig, ShapeConfig, SHAPES,
                   get_config, list_archs, register, smoke_config)
