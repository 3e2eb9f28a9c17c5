from .chgnet import CHGNet, CHGNetConfig
from .mace import MACE, MACEConfig
from .tensornet import TensorNet, TensorNetConfig

__all__ = ["CHGNet", "CHGNetConfig", "MACE", "MACEConfig", "TensorNet",
           "TensorNetConfig"]
