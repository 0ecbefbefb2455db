"""Models: DynamicMarkovBlanketDiscovery, the linear dynamical systems and
the pieces they are built from."""
from .arhmm import ARHMM_prXRY
from .dmbd import DynamicMarkovBlanketDiscovery
from .hmm import HMM
from .lds import LinearDynamicalSystems
from .mix_lds import MixtureofLinearDynamicalSystems

__all__ = [
    "ARHMM_prXRY",
    "DynamicMarkovBlanketDiscovery",
    "HMM",
    "LinearDynamicalSystems",
    "MixtureofLinearDynamicalSystems",
]
