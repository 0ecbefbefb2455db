"""Models: DynamicMarkovBlanketDiscovery and the pieces it is built from."""
from .arhmm import ARHMM_prXRY
from .dmbd import DynamicMarkovBlanketDiscovery
from .hmm import HMM
from .lds import LinearDynamicalSystems

__all__ = [
    "ARHMM_prXRY",
    "DynamicMarkovBlanketDiscovery",
    "HMM",
    "LinearDynamicalSystems",
]
