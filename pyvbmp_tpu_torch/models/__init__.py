"""Models: DynamicMarkovBlanketDiscovery, the linear dynamical systems, the
HMM family, the mixture models and the pieces they are built from."""
from .arhmm import ARHMM, ARHMM_prXY, ARHMM_prXRY
from .dhmm import dHMM
from .dmbd import DynamicMarkovBlanketDiscovery
from .gmm import GaussianMixtureModel, PoissonMixtureModel
from .hmm import HMM
from .lds import LinearDynamicalSystems
from .mix_lds import MixtureofLinearDynamicalSystems
from .nlds import NLDS, NonLinearDynamicalSystems

__all__ = [
    "ARHMM",
    "ARHMM_prXY",
    "ARHMM_prXRY",
    "DynamicMarkovBlanketDiscovery",
    "GaussianMixtureModel",
    "HMM",
    "LinearDynamicalSystems",
    "MixtureofLinearDynamicalSystems",
    "NLDS",
    "NonLinearDynamicalSystems",
    "PoissonMixtureModel",
    "dHMM",
]
