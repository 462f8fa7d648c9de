from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import (SHAPE_IDS, SHAPES, ShapeSpec,
                                        cell_applicable, get_shape)
