from .chgnet import CHGNet, CHGNetConfig
from .escn import ESCN, ESCNConfig
from .mace import MACE, MACEConfig
from .tensornet import TensorNet, TensorNetConfig

__all__ = ["CHGNet", "CHGNetConfig", "ESCN", "ESCNConfig", "MACE", "MACEConfig",
           "TensorNet", "TensorNetConfig"]
