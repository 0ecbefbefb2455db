"""Bayesian linear transforms and classifiers."""
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart
from .mnlr import MultiNomialLogisticRegression
from .mnlr_bouchard import MultiNomialLogisticRegression_Bouchard
from .dmix_linear_transforms import dMixtureofLinearTransforms
from .nl_regression import NLRegression_Multinomial

__all__ = [
    "MatrixNormalGamma",
    "MatrixNormalWishart",
    "MultiNomialLogisticRegression",
    "MultiNomialLogisticRegression_Bouchard",
    "dMixtureofLinearTransforms",
    "NLRegression_Multinomial",
]
