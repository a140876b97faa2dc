"""Model fixtures (reference test/runtests.jl:4-33). The port has the
Rosenbrock fixture; the JAX package's other models come in later slices."""

from .rosenbrock import Rosenbrock, rosenbrock_logdensity, rosenbrock_value_and_grad

__all__ = ["Rosenbrock", "rosenbrock_logdensity", "rosenbrock_value_and_grad"]
