from repro_torch.configs.base import DFAConfig
from repro_torch.configs.dfa import PAPER, REDUCED

__all__ = ["DFAConfig", "PAPER", "REDUCED"]
