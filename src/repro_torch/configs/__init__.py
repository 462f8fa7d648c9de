from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
