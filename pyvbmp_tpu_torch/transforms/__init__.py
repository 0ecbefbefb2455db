"""Bayesian linear transforms."""
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart

__all__ = ["MatrixNormalGamma", "MatrixNormalWishart"]
