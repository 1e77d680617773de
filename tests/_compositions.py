"""Shared step compositions for the jnp-step matrix tests.

Each composition is a small configuration of one mechanism the projection
step composes: obstacle masks, outflow and convective outlets, periodic
axes, static and callable forcing, time-dependent BC values, scalar
transport with buoyancy and heated bodies, static and moving IBM, cut-cell
pressure and CFL-adaptive dt. ``build(name, dtype, integrator)`` returns
the Simulation; ``run`` steps it; the ``check_*`` functions hold a run to
the step's contracts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from navierstokessolver_tpu import bcs as bcs_mod
from navierstokessolver_tpu.bcs import BCKind, BCSpec, no_slip_box
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops.poisson import PoissonConfig
from navierstokessolver_tpu.scalar import ScalarBC, ScalarConfig
from navierstokessolver_tpu.solver import SimParams, Simulation

STEPS = 5

_CYL = dict(shape=(48, 24), lengths=(8.0, 4.0), center=(2.0, 2.03),
            re=100.0)
_SPH = dict(shape=(24, 12, 12), lengths=(12.0, 6.0, 6.0),
            center=(3.0, 3.05, 2.95), diameter=1.8, re=100.0)


def _case(name, **kw):
    def build(dtype, integrator):
        return make_case(name, dtype=dtype, integrator=integrator, **kw).sim
    return build


def _cfl(name, **kw):
    def build(dtype, integrator):
        return make_case(name, dtype=dtype, integrator=integrator,
                         cfl=0.01, **kw).sim
    return build


def _pulsing_inflow(dtype, integrator):
    """Time-dependent INFLOW value into a duct with an obstacle and an
    outflow face: callable BC values composed with masks."""
    g = GridSpec(shape=(24, 12, 12), lengths=(4.0, 2.0, 2.0), dtype=dtype)
    bcs = no_slip_box(g)
    bcs[(0, 0)] = BCSpec.inflow(
        (lambda t: 1.0 + 0.3 * jnp.sin(6.0 * t), 0.0, 0.0))
    bcs[(0, 1)] = BCSpec.outflow()
    solid = np.zeros(g.shape, bool)
    solid[9:13, 5:8, 5:8] = True
    params = SimParams(dt=4e-3, nu=0.02, integrator=integrator,
                       poisson=PoissonConfig(method="mg", tol=1e-6,
                                             max_iters=80))
    return Simulation.build(g, bcs, params, solid=solid)


def _adiabatic_body(dtype, integrator):
    """Passive scalar with an INSULATED immersed block in a driven box."""
    g = GridSpec(shape=(16, 12, 12), lengths=(1.0, 1.0, 1.0), dtype=dtype)
    bcs = no_slip_box(g)
    bcs[(2, 1)] = BCSpec.wall((1.0, 0.0, 0.0))
    solid = np.zeros(g.shape, bool)
    solid[4:8, 4:8, 3:6] = True
    sc_bcs = {(a, s): ScalarBC.adiabatic() for a in range(3) for s in (0, 1)}
    sc_bcs[(0, 0)] = ScalarBC.dirichlet(1.0)
    sc_bcs[(0, 1)] = ScalarBC.dirichlet(0.0)
    scalar = ScalarConfig(bcs=sc_bcs, diffusivity=0.02,
                          body_bc=ScalarBC.adiabatic())
    params = SimParams(dt=3e-3, nu=0.02, integrator=integrator,
                       poisson=PoissonConfig(method="mg", tol=1e-6,
                                             max_iters=80))
    return Simulation.build(g, bcs, params, solid=solid, scalar=scalar)


COMPOSITIONS_2D = {
    "cavity_fft": _case("cavity", shape=(16, 16)),
    "cavity_cg_upwind": _case("cavity", shape=(16, 16), re=1000.0,
                              poisson_method="cg", upwind_gamma=0.5),
    "cylinder_masks_dctcg": _case("cylinder", **_CYL),
    "cylinder_masks_mg": _case("cylinder", poisson_method="mg", **_CYL),
    "cylinder_convective": _case("cylinder", poisson_method="mg",
                                 outlet="convective", **_CYL),
    "channel_outflow": _case("channel", shape=(32, 16)),
    "taylor_green_periodic": _case("taylor_green", shape=(16, 16)),
    "channel_periodic_forcing": _case("channel_periodic", shape=(16, 16)),
    "kolmogorov_field_forcing": _case("kolmogorov", shape=(16, 16),
                                      re=5.0),
    "pulsatile_callable_forcing": _case("pulsatile_channel",
                                        shape=(16, 16)),
    "oscillating_lid_bc_values": _case("oscillating_lid", shape=(16, 16)),
    "heated_cavity_buoyancy": _case("heated_cavity", shape=(16, 16)),
    "rayleigh_benard_periodic": _case("rayleigh_benard", shape=(24, 12)),
    "heated_cylinder_body": _case("heated_cylinder", poisson_method="mg",
                                  **_CYL),
    "heated_enclosure_buoyant_body": _case("heated_enclosure",
                                           shape=(24, 24)),
    "ibm_cylinder": _case("cylinder", poisson_method="mg", ibm=True, **_CYL),
    "ibm_spinning_cylinder": _case("cylinder", poisson_method="mg",
                                   ibm=True, spin=0.5, **_CYL),
    "cutcell_cylinder": _case("cylinder", poisson_method="mg", ibm=True,
                              sharp_pressure=True, **_CYL),
    "cavity_cfl": _cfl("cavity", shape=(16, 16)),
}

COMPOSITIONS_3D = {
    "cavity3d_fft": _case("cavity3d", shape=(16, 12, 12),
                          poisson_method="fft"),
    "sphere_masks_dctcg": _case("sphere", **_SPH),
    "sphere_convective_mg": _case("sphere", poisson_method="mg",
                                  outlet="convective", **_SPH),
    "taylor_green3d_periodic": _case("taylor_green3d", shape=(16, 12, 12),
                                     re=200.0),
    "duct_periodic_forcing": _case("duct_periodic", shape=(16, 8, 8)),
    "kolmogorov3d_field_forcing": _case("kolmogorov", shape=(16, 12, 12),
                                        re=5.0),
    "oscillating_lid3d_bc_values": _case("oscillating_lid",
                                         shape=(16, 12, 12)),
    "pulsing_inflow_masks": _pulsing_inflow,
    "heated_cavity3d_buoyancy": _case("heated_cavity", shape=(16, 12, 12)),
    "heated_sphere_body": _case("sphere", poisson_method="mg", heated=True,
                                **_SPH),
    "adiabatic_body": _adiabatic_body,
    "ibm_sphere": _case("sphere", poisson_method="mg", ibm=True, **_SPH),
    "ibm_spinning_sphere": _case("sphere", poisson_method="mg", ibm=True,
                                 spin=0.5, **_SPH),
    "cutcell_sphere": _case("sphere", poisson_method="mg", ibm=True,
                            sharp_pressure=True, **_SPH),
    "cavity3d_cfl": _cfl("cavity3d", shape=(16, 12, 12),
                         poisson_method="fft"),
}


def build(name, dtype, integrator):
    table = {**COMPOSITIONS_2D, **COMPOSITIONS_3D}
    return table[name](dtype, integrator)


def run(name, dtype, integrator, steps=STEPS):
    """(sim, final state, diagnostics) as host numpy arrays where useful.
    float64 runs enable x64 for their own duration only."""
    def go():
        sim = build(name, dtype, integrator)
        st, d = sim.run_scan(sim.initial_state(), steps)
        return sim, st, d

    if dtype == jnp.float64:
        with jax.enable_x64(True):
            sim, st, d = go()
            st = jax.tree_util.tree_map(np.asarray, st)
            d = jax.tree_util.tree_map(np.asarray, d)
        return sim, st, d
    return go()


def boundary_mismatch(sim, st, d) -> float:
    """max |u - BC(u)| over the boundary face slabs of every velocity
    component along its own axis (Dirichlet values, outflow copies,
    periodic mirrors; convective faces own their value). Time-dependent
    values resolve at the last step's start time."""
    b = sim.bcs
    if bcs_mod.bcs_time_dependent(b):
        t_last = float(np.asarray(st.t)) - float(np.asarray(d.dt)[-1])
        b = bcs_mod.resolve_bcs(b, jnp.asarray(t_last, sim.grid.dtype))
    u = tuple(jnp.asarray(c) for c in st.u)
    ref = bcs_mod.apply_velocity_bcs(sim.grid, b, u, sim.face_masks)
    if sim.ibm is not None:
        ref = sim.ibm.apply_wet(ref)
    worst = 0.0
    for a in range(sim.grid.ndim):
        for side in (0, 1):
            if b[(a, side)].kind is BCKind.CONVECTIVE:
                continue
            idx = [slice(None)] * sim.grid.ndim
            idx[a] = 0 if side == 0 else -1
            diff = np.abs(np.asarray(u[a])[tuple(idx)]
                          - np.asarray(ref[a])[tuple(idx)])
            worst = max(worst, float(diff.max()))
    return worst


def velocity_scale(st) -> float:
    return max(float(np.max(np.abs(np.asarray(c)))) for c in st.u)


# max|div u| against the velocity-gradient scale U/h: every composition
# measured <= 1.4e-4 (the outflow/obstacle columns carry the known
# zero-gradient-copy artifact), f64 and f32 alike
DIV_BOUND = 1e-3
# f32 vs f64 after STEPS steps, relative to max|u|: measured <= 7e-6
F32_VS_F64 = 1e-4


def check_finite_and_divergence(sim, st, d):
    for leaf in jax.tree_util.tree_leaves(st):
        assert np.isfinite(np.asarray(leaf)).all()
    scale = velocity_scale(st) / min(sim.grid.spacing)
    max_div = float(np.asarray(d.max_div)[-1])
    assert max_div <= DIV_BOUND * max(scale, 1e-30), (max_div, scale)


def check_boundary_faces(sim, st, d):
    assert boundary_mismatch(sim, st, d) <= 1e-6 * max(1.0, velocity_scale(st))


def check_f32_matches_f64(run32, run64):
    (_, a, _), (_, b, _) = run32, run64
    scale = max(velocity_scale(b), 1e-30)
    for ca, cb in zip(a.u, b.u):
        diff = float(np.max(np.abs(np.asarray(ca, np.float64)
                                   - np.asarray(cb, np.float64))))
        assert diff <= F32_VS_F64 * scale, (diff, scale)
