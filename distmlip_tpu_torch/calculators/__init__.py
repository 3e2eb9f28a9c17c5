from .atoms import AMU_A2_FS2_TO_EV, EV_A3_TO_GPA, KB, Atoms
from .batched import BatchedMD, BatchedPotential, BatchedRelaxer
from .calculator import UMA_TASK_DATASETS, DistPotential, EnsemblePotential, UMAPredictor
from .device_md import DeviceMD
from .elements import MASSES, SYMBOLS, symbols_to_numbers
from .md import ENSEMBLES, MolecularDynamics, TrajectoryObserver
from .relax import RelaxResult, Relaxer

__all__ = [
    "Atoms", "KB", "AMU_A2_FS2_TO_EV", "EV_A3_TO_GPA",
    "MASSES", "SYMBOLS", "symbols_to_numbers",
    "DistPotential", "EnsemblePotential", "UMAPredictor", "UMA_TASK_DATASETS",
    "BatchedPotential", "BatchedRelaxer", "BatchedMD",
    "ENSEMBLES", "MolecularDynamics", "TrajectoryObserver", "DeviceMD",
    "Relaxer", "RelaxResult",
]
