"""Benchmark/validation case registry.

One entry per BASELINE.json config (SURVEY.md SS2 "Config/CLI" row):
  cavity        -- 2D lid-driven cavity, Re=100, 64x64 (config #1)
  channel       -- 2D Poiseuille channel, inflow/outflow, 256x64 (config #2)
  cylinder      -- 2D flow past a cylinder, Re=200, 512x256 (config #3)
  cavity_hi_re  -- 2D cavity, Re=10k, 2048^2 (config #4)
  cavity3d      -- 3D lid-driven cavity, 256^3 (config #5)

Beyond the BASELINE set:
  channel_periodic    -- body-force-driven periodic channel
  taylor_green        -- fully periodic analytic-decay oracle
  heated_cavity       -- de Vahl Davis natural convection (2D/3D)
  rayleigh_benard     -- periodic-x convection, critical-Ra oracle
  decaying_turbulence -- 2D periodic turbulence, inverse-cascade oracle
  sphere              -- 3D flow past a sphere (unsteady wake at Re=300)
  duct_periodic       -- 3D body-force duct, exact series-profile oracle
  kolmogorov          -- sinusoidally forced periodic box (2D/3D), exact
                         laminar-balance oracle; spatially varying forcing
  pulsatile_channel   -- Womersley flow (oscillating body force); exact
                         semi-discrete oracle; time-dependent forcing
  heated_cylinder     -- forced convection from an isothermal cylinder
                         (scalar + obstacle); Churchill-Bernstein Nu oracle
  heated_enclosure    -- natural convection from a hot cylinder in a cold
                         box (scalar + obstacle + buoyancy); exact energy-
                         balance oracle
  oscillating_lid     -- cavity whose lid slides at cos(omega t): time-
                         dependent BC VALUES resolved inside one scan

Each builder accepts overrides so tests can shrink grids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..grid import GridSpec, State
from ..solver import Simulation

from .cavity import build_cavity, build_cavity3d, build_oscillating_lid
from .channel import (
    build_channel,
    build_channel_periodic,
    build_pulsatile_channel,
    build_duct_periodic,
)
from .convection import (
    build_heated_cavity,
    build_heated_enclosure,
    build_rayleigh_benard,
)
from .cylinder import build_cylinder, build_sphere
from .kolmogorov import build_kolmogorov
from .taylor_green import build_taylor_green, build_taylor_green3d
from .turbulence import build_decaying_turbulence


@dataclasses.dataclass(eq=False)
class Case:
    name: str
    sim: Simulation
    suggested_steps: int
    description: str = ""

    def initial_state(self) -> State:
        return self.sim.initial_state()


_REGISTRY: dict[str, Callable[..., Case]] = {
    "cavity": build_cavity,
    "cavity_hi_re": lambda **kw: build_cavity(
        **{
            "shape": (2048, 2048),
            "re": 10_000.0,
            "poisson_method": "fft",
            "upwind_gamma": 0.8,
            **kw,
        }
    ),
    "cavity3d": build_cavity3d,
    "oscillating_lid": build_oscillating_lid,
    "channel": build_channel,
    "channel_periodic": build_channel_periodic,
    "duct_periodic": build_duct_periodic,
    "cylinder": build_cylinder,
    "heated_cylinder": lambda **kw: build_cylinder(**{"heated": True, **kw}),
    "sphere": build_sphere,
    "taylor_green": build_taylor_green,
    "taylor_green3d": build_taylor_green3d,
    "heated_cavity": build_heated_cavity,
    "heated_enclosure": build_heated_enclosure,
    "rayleigh_benard": build_rayleigh_benard,
    "decaying_turbulence": build_decaying_turbulence,
    "kolmogorov": build_kolmogorov,
    "pulsatile_channel": build_pulsatile_channel,
}


def available_cases() -> list[str]:
    return sorted(_REGISTRY)


def make_case(name: str, **overrides) -> Case:
    if name not in _REGISTRY:
        raise KeyError(f"unknown case {name!r}; available: {available_cases()}")
    return _REGISTRY[name](**overrides)
