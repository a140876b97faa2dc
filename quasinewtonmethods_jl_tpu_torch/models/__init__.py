"""Model fixtures (reference test/runtests.jl:4-33) and the BASELINE.md
benchmark configs: every model of the JAX package."""

from .funnel import FUNNEL_V_STD, funnel_logdensity
from .hierarchical import HierarchicalRegression
from .logistic import LogisticRegressionMAP
from .mixture import GaussianMixture
from .poisson import PoissonRegressionMAP
from .quadratic import IllConditionedQuadratic, quadratic_logdensity
from .rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad
from .statespace import AR1DriftMAP

__all__ = [
    "AR1DriftMAP",
    "FUNNEL_V_STD",
    "funnel_logdensity",
    "HierarchicalRegression",
    "LogisticRegressionMAP",
    "GaussianMixture",
    "PoissonRegressionMAP",
    "IllConditionedQuadratic",
    "quadratic_logdensity",
    "Rosenbrock",
    "rosenbrock_logdensity",
    "rosenbrock_value_and_grad",
]
