from .chgnet import CHGNet, CHGNetConfig
from .escn import ESCN, ESCNConfig
from .escn_md import ESCNMD, ESCNMDConfig
from .mace import MACE, MACEConfig
from .pair import PairConfig, PairPotential, zbl_edge_energy
from .tensornet import TensorNet, TensorNetConfig

__all__ = ["CHGNet", "CHGNetConfig", "ESCN", "ESCNConfig", "ESCNMD", "ESCNMDConfig", "MACE",
           "MACEConfig", "PairConfig", "PairPotential", "TensorNet", "TensorNetConfig",
           "zbl_edge_energy"]
