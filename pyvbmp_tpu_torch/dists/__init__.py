"""Conjugate exponential-family nodes and message types."""
from .delta import Delta
from .diagonal_wishart import DiagonalWishart
from .dirichlet import Dirichlet
from .gamma import Gamma
from .mixture import Mixture
from .mvn_ard import MVN_ard
from .mvn_vector_format import MultivariateNormal_vector_format
from .niw import NormalInverseWishart
from .normal_gamma import NormalGamma
from .wishart import Wishart

__all__ = [
    "Delta",
    "DiagonalWishart",
    "Dirichlet",
    "Gamma",
    "Mixture",
    "MVN_ard",
    "MultivariateNormal_vector_format",
    "NormalGamma",
    "NormalInverseWishart",
    "Wishart",
]
