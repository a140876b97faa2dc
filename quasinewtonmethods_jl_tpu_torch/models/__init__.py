"""Model fixtures (reference test/runtests.jl:4-33). The port has the
Rosenbrock fixture, the ill-conditioned quadratic and the logistic
regression MAP; the JAX package's other models come in later slices."""

from .logistic import LogisticRegressionMAP
from .quadratic import IllConditionedQuadratic, quadratic_logdensity
from .rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad

__all__ = [
    "IllConditionedQuadratic",
    "LogisticRegressionMAP",
    "quadratic_logdensity",
    "Rosenbrock",
    "rosenbrock_logdensity",
    "rosenbrock_value_and_grad",
]
