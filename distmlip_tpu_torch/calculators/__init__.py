from .atoms import AMU_A2_FS2_TO_EV, EV_A3_TO_GPA, KB, Atoms
from .calculator import DistPotential
from .elements import MASSES, SYMBOLS, symbols_to_numbers

__all__ = [
    "Atoms", "KB", "AMU_A2_FS2_TO_EV", "EV_A3_TO_GPA",
    "MASSES", "SYMBOLS", "symbols_to_numbers",
    "DistPotential",
]
