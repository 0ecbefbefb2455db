"""Bayesian linear transforms, classifiers, mixtures of experts, the
transformer stacks and the Markov transition nodes (the JAX package's
exported set)."""
from .bayesian_transformers import (
    ChainedBayesianTransformer,
    DiscreteBayesianTransformer,
    FocusedBayesianTransformer,
    GenerativeBayesianTransformer,
)
from .dmix_linear_transforms import dMixtureofLinearTransforms
from .dmixture import dMixture
from .matrix_normal_gamma import MatrixNormalGamma, MatrixNormalGamma_UnitTrace
from .matrix_normal_wishart import MatrixNormalWishart
from .mixture_of_linear_transforms import MixtureofLinearTransforms
from .mnlr import MultiNomialLogisticRegression
from .mnlr_bouchard import MultiNomialLogisticRegression_Bouchard
from .multilinear_normal_wishart import MultiLinearNormalWishart
from .nl_regression import (
    NLRegression_Multinomial,
    NLRegression_full_rank,
    NLRegression_low_rank,
)
from .reduced_rank_regression import ReducedRankRegression
from .transition import HierarchicalTransition, Transition

__all__ = [
    "ChainedBayesianTransformer",
    "DiscreteBayesianTransformer",
    "FocusedBayesianTransformer",
    "GenerativeBayesianTransformer",
    "HierarchicalTransition",
    "MatrixNormalGamma",
    "MatrixNormalGamma_UnitTrace",
    "MatrixNormalWishart",
    "MixtureofLinearTransforms",
    "MultiLinearNormalWishart",
    "MultiNomialLogisticRegression",
    "MultiNomialLogisticRegression_Bouchard",
    "NLRegression_Multinomial",
    "NLRegression_full_rank",
    "NLRegression_low_rank",
    "ReducedRankRegression",
    "Transition",
    "dMixture",
    "dMixtureofLinearTransforms",
]
