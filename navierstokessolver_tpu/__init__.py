"""navierstokessolver_tpu: an incompressible Navier-Stokes engine in JAX.

A jax/XLA implementation of the capabilities of the reference
solver `shivams15/navierstokessolver` (see SURVEY.md; the reference mount was
empty this session, so parity targets come from the driver's BASELINE.json
capability spec): staggered MAC grid, no-slip/moving-lid/inflow/outflow/
obstacle BCs, Chorin projection with Jacobi/Gauss-Seidel/SOR/CG pressure
solvers, jit-scanned step loop, domain-decomposed multi-device sharding. It runs
on NVIDIA GPUs (tests on the CPU); the package name is historical.
"""

from . import adjoint
from .grid import GridSpec, State, zero_state, interpolate_to_centers
from .bcs import BCKind, BCSpec, BCTable, no_slip_box
from .ibm import IBMForcing, build_ibm, solid_from_sdf
from .les import LESConfig
from .ops.poisson import PoissonConfig, PoissonOp, build_poisson_op, solve_poisson
from .solver import SimParams, Simulation, StepDiagnostics

__version__ = "0.1.0"

__all__ = [
    "adjoint",
    "GridSpec",
    "State",
    "zero_state",
    "interpolate_to_centers",
    "BCKind",
    "BCSpec",
    "BCTable",
    "no_slip_box",
    "IBMForcing",
    "build_ibm",
    "solid_from_sdf",
    "LESConfig",
    "PoissonConfig",
    "PoissonOp",
    "build_poisson_op",
    "solve_poisson",
    "SimParams",
    "Simulation",
    "StepDiagnostics",
]
