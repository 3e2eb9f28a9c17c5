from .mace import MACE, MACEConfig

__all__ = ["MACE", "MACEConfig"]
