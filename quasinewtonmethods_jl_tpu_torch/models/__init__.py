"""Model fixtures (reference test/runtests.jl:4-33). The port has the
Rosenbrock fixture and the ill-conditioned quadratic; the JAX package's
other models come in later slices."""

from .quadratic import IllConditionedQuadratic, quadratic_logdensity
from .rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad

__all__ = [
    "IllConditionedQuadratic",
    "quadratic_logdensity",
    "Rosenbrock",
    "rosenbrock_logdensity",
    "rosenbrock_value_and_grad",
]
