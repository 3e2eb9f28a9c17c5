from .mace import MACE, MACEConfig
from .tensornet import TensorNet, TensorNetConfig

__all__ = ["MACE", "MACEConfig", "TensorNet", "TensorNetConfig"]
