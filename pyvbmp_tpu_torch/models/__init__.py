"""Models: DynamicMarkovBlanketDiscovery, the linear dynamical systems, the
HMM family (the tensor-state HMMs among it), the mixture models and the
pieces they are built from."""
from .arhmm import ARHMM, ARHMM_prXY, ARHMM_prXRY
from .dhmm import dHMM
from .dmbd import DynamicMarkovBlanketDiscovery
from .gmm import GaussianMixtureModel, PoissonMixtureModel
from .hmm import HMM
from .lds import LinearDynamicalSystems
from .mix_lds import MixtureofLinearDynamicalSystems
from .nlds import NLDS, NonLinearDynamicalSystems
from .tensor_hmm import HHMM, Factorial_HMM, Tensor_HMM

__all__ = [
    "ARHMM",
    "ARHMM_prXY",
    "ARHMM_prXRY",
    "DynamicMarkovBlanketDiscovery",
    "Factorial_HMM",
    "GaussianMixtureModel",
    "HHMM",
    "HMM",
    "LinearDynamicalSystems",
    "MixtureofLinearDynamicalSystems",
    "NLDS",
    "NonLinearDynamicalSystems",
    "PoissonMixtureModel",
    "Tensor_HMM",
    "dHMM",
]
