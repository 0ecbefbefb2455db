"""Conjugate exponential-family nodes and message types."""
from .delta import Delta
from .diagonal_wishart import DiagonalWishart, DiagonalWishartUnitTrace
from .dirichlet import Dirichlet
from .gamma import Gamma
from .hierarchical_dirichlet import Hierarchical_Dirichlet
from .mixture import Mixture
from .mvn_ard import MVN_ard
from .mvn_matrix_format import MultivariateNormal
from .mvn_vector_format import MultivariateNormal_vector_format
from .niw import NormalInverseWishart
from .niw_vector_format import (
    GMM_vector,
    NormalInverseWishart_vector_format,
    NormalInverseWishart_vector_format_invSigma,
)
from .normal_gamma import NormalGamma
from .tensor_normal_wishart import TensorNormalWishart
from .wishart import Wishart, WishartEigh, WishartUnitDet, WishartUnitTrace

__all__ = [
    "Delta",
    "DiagonalWishart",
    "DiagonalWishartUnitTrace",
    "Dirichlet",
    "GMM_vector",
    "Gamma",
    "Hierarchical_Dirichlet",
    "Mixture",
    "MVN_ard",
    "MultivariateNormal",
    "MultivariateNormal_vector_format",
    "NormalGamma",
    "NormalInverseWishart",
    "NormalInverseWishart_vector_format",
    "NormalInverseWishart_vector_format_invSigma",
    "TensorNormalWishart",
    "Wishart",
    "WishartEigh",
    "WishartUnitDet",
    "WishartUnitTrace",
]
