"""eigensolver_tpu: MHD eigensolver framework in JAX.

A JAX/XLA implementation of the capabilities of
samuelskirvin/EIGENSOLVER: dispersion diagrams, eigenvalues and eigenfunctions
of magnetoacoustic waves in non-uniform magnetic slabs and cylinders, with
density, longitudinal-flow and rotational-flow equilibria, real and complex
(Kelvin-Helmholtz) frequencies, mode analysis, field synthesis, movies and VTK
export. See SURVEY.md for the structural map of the reference.
"""
from . import analytic, config, profiles, equilibrium, ode  # noqa: F401
from .config import (  # noqa: F401
    CaseConfig,
    Geometry,
    GridConfig,
    ProfileConfig,
    ProfileKind,
    Regime,
    Tolerances,
)

__version__ = "0.1.0"
