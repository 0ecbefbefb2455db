"""Bayesian linear transforms, classifiers and Markov transition nodes."""
from .matrix_normal_gamma import MatrixNormalGamma, MatrixNormalGamma_UnitTrace
from .matrix_normal_wishart import MatrixNormalWishart
from .mnlr import MultiNomialLogisticRegression
from .mnlr_bouchard import MultiNomialLogisticRegression_Bouchard
from .dmix_linear_transforms import dMixtureofLinearTransforms
from .nl_regression import NLRegression_Multinomial
from .transition import HierarchicalTransition, Transition

__all__ = [
    "HierarchicalTransition",
    "MatrixNormalGamma",
    "MatrixNormalGamma_UnitTrace",
    "MatrixNormalWishart",
    "MultiNomialLogisticRegression",
    "MultiNomialLogisticRegression_Bouchard",
    "Transition",
    "dMixtureofLinearTransforms",
    "NLRegression_Multinomial",
]
