"""Explicit halo-exchange Poisson solve: shard_map + ppermute over ICI.

SURVEY.md SS5: "the halo exchange IS the ring (neighbor ppermute over ICI)".
The GSPMD path (sharding.py) lets XLA insert halo collectives automatically;
this module is the hand-written equivalent for the hottest distributed loop
-- the pressure relaxation/CG iteration -- with the communication explicit:

  * slab (1D), pencil (2D) or block (3D) decomposition: spatial mesh axis
    ``sx``/``sy``/``sz`` shards grid axis 0/1/2;
  * per operator application, each device ppermutes its boundary slabs to
    its ring neighbors along every sharded axis; non-periodic ring ends
    receive zeros (boundary cells have their coupling bits cleared in the
    stencil code, so the ghost content is multiplied by zero), periodic
    axes close the ring with a wraparound link;
  * the operator travels as the compressed uint8 stencil code + f32
    diagonal (ops/poisson.py representation);
  * red-black parity is synthesized from iota plus the shard's global
    offsets, never streamed;
  * global reductions (residual norms, CG dots, nullspace deflation) are
    ``lax.psum`` over the mesh axes;
  * the whole while_loop runs inside one shard_map'd program: every device
    evaluates the same psum'd predicate, so control flow stays lockstep
    with zero host round-trips.

The solver BODIES are ops/poisson.solve_poisson with a ShardCtx -- one
implementation, identical convergence semantics in both modes (VERDICT r1
item 4 replaced the former forked re-implementation). Production dispatch:
``parallel.sharded_simulation(sim, mesh, poisson_comm="halo")`` routes
``Simulation._solve_pressure`` here for jacobi/gs/sor/cg runs.
"""

from __future__ import annotations

import dataclasses

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import GridSpec
from ..ops.poisson import PoissonConfig, PoissonOp, ShardCtx, solve_poisson
from .sharding import SPATIAL_AXES

Array = jax.Array


@dataclasses.dataclass(eq=False)
class ShardedPoissonSolver:
    """Distributed pressure solve over a 1D/2D/3D spatial device mesh."""

    grid: GridSpec
    mesh: Mesh
    op: PoissonOp
    cfg: PoissonConfig
    _mapped: object = None
    _mg: object = None   # MGPoissonSolver for cfg.method mg/mgcg

    _dctcg: object = None
    dctcg_consts: object = None

    @staticmethod
    def build(
        grid: GridSpec, op: PoissonOp, mesh: Mesh, cfg: PoissonConfig,
        mg=None, dctcg=None,
    ) -> "ShardedPoissonSolver":
        """``mg``: the Simulation's MGPoissonSolver, required for
        cfg.method "mg"/"mgcg" -- the V-cycle then runs inside the same
        shard_map block: fine levels on block-local arrays with ppermute
        ghost exchange in the smoother/operator/prolongation, coarse
        levels (below ops/multigrid.shard_split) replicated via one
        all_gather per cycle (they are tiny)."""
        nd = grid.ndim
        names = tuple(mesh.axis_names)
        if len(names) > nd or names != SPATIAL_AXES[: len(names)]:
            raise ValueError(
                f"ShardedPoissonSolver needs a spatial mesh whose axis "
                f"names are a prefix of {SPATIAL_AXES} (grid axis i shards "
                f"over mesh axis i); got {names}"
            )
        if cfg.method not in ("jacobi", "gs", "sor", "cg", "mg", "mgcg",
                              "dctcg"):
            raise ValueError(
                f"explicit halo-exchange path supports "
                f"jacobi/gs/sor/cg/mg/mgcg/dctcg, not {cfg.method!r}"
            )
        if cfg.method in ("mg", "mgcg") and mg is None:
            raise ValueError(f"method {cfg.method!r} needs the mg solver")
        if cfg.method == "dctcg":
            if dctcg is None:
                raise ValueError("method 'dctcg' needs the DCTPCGSolver")
            if grid.ndim not in (2, 3) or len(names) != 1:
                raise ValueError(
                    "explicit-halo dctcg covers 2D/3D grids on a 1D 'sx' "
                    "slab mesh (the production cylinder/sphere "
                    "topologies); use poisson_comm='gspmd' elsewhere"
                )
        if op.ap is not None:
            raise ValueError(
                "cut-cell (sharp_pressure) operators are not supported on "
                "the explicit-halo tier yet; use poisson_comm='gspmd'"
            )
        sizes = dict(zip(names, mesh.devices.shape))
        for a, name in enumerate(names):
            if grid.shape[a] % sizes[name]:
                raise ValueError(
                    f"grid axis {a} ({grid.shape[a]}) must divide over "
                    f"{sizes[name]} devices"
                )
        axes = tuple(
            (names[a] if a < len(names) and sizes[names[a]] > 1 else None)
            for a in range(nd)
        )
        ctx = ShardCtx(
            axes=axes,
            sizes=tuple(
                sizes[names[a]] if a < len(names) else 1 for a in range(nd)
            ),
        )
        spec = P(*names, *([None] * (nd - len(names))))

        if cfg.method in ("mg", "mgcg"):
            from ..ops import multigrid

            split = multigrid.shard_split(
                [tuple(o.diag.shape) for o in mg.ops], ctx
            )
            # sharded levels get block-local operator arrays; replicated
            # (coarse) levels see the full arrays on every device
            level_specs = [
                (spec if l < split else P())
                for l in range(len(mg.ops))
            ]
            def body(b, p0, diag, code, levels):
                ops_local = [
                    dataclasses.replace(o, diag=d, code=c)
                    for o, (d, c) in zip(mg.ops, levels)
                ]
                solver = dataclasses.replace(mg, ops=ops_local)
                mg_solve = (solver.solve_pcg if cfg.method == "mgcg"
                            else solver.solve)
                return mg_solve(b, p0, cfg.tol, cfg.max_iters,
                                ctx=ctx, split=split)

            mapped = jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(spec, spec, spec, spec,
                          tuple((s, s) for s in level_specs)),
                out_specs=(spec, P(), P()),
            )
        elif cfg.method == "dctcg":
            n_dev = int(mesh.devices.shape[0])
            if grid.shape[1] % n_dev:
                raise ValueError(
                    f"explicit-halo dctcg: axis-1 extent {grid.shape[1]} "
                    f"must divide over {n_dev} devices (pencil transpose)"
                )
            hc0 = dctcg.halo_consts()
            if hc0 is None:
                raise ValueError(
                    "explicit-halo dctcg needs the matmul-mode spectral "
                    "arrays (DCTPCGSolver.halo_consts; 2D spectral-"
                    "Woodbury or 3D slab form)"
                )
            axis = names[0]
            # per-leaf shard specs: k1-sliced leaves ride the mesh axis
            # (the 3D inv_nat (k0, k1, k2) shards over its middle axis)
            hc_specs = {
                k: (P(None, axis, None) if k == "inv_nat" and grid.ndim == 3
                    else P(None, axis) if k in ("inv_nat", "vy")
                    else P(axis, None) if k == "fy" else P())
                for k in hc0
            }

            def body(b, p0, diag, code, hc):
                op_local = dataclasses.replace(op, diag=diag, code=code)
                return dctcg.solve_halo(
                    hc, b, p0, cfg.tol, cfg.max_iters, op_local, ctx, axis
                )

            mapped = jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(spec, spec, spec, spec, hc_specs),
                out_specs=(spec, P(), P()),
            )
            return ShardedPoissonSolver(
                grid=grid, mesh=mesh, op=op, cfg=cfg, _mapped=mapped,
                _dctcg=dctcg, dctcg_consts=hc0,
            )
        else:
            def body(b, p0, diag, code, levels):
                # diag/code arrive as the local blocks; rebuild a
                # block-local view of the operator (w/singular/
                # inv_fluid_count are global statics -- deflation psums
                # local sums against the GLOBAL reciprocal fluid count).
                op_local = dataclasses.replace(op, diag=diag, code=code)
                return solve_poisson(op_local, b, p0, grid, cfg, ctx=ctx)

            mapped = jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(spec, spec, spec, spec, P()),
                out_specs=(spec, P(), P()),
            )
        return ShardedPoissonSolver(
            grid=grid, mesh=mesh, op=op, cfg=cfg, _mapped=mapped, _mg=mg
        )

    def solve(self, b: Array, p0: Array, op: PoissonOp = None, mg_ops=None,
              dctcg_consts=None):
        """Returns (p, iters, relative residual), p sharded over the mesh.

        Pass ``op`` (and ``mg_ops`` for mg/mgcg, ``dctcg_consts`` for
        dctcg) explicitly when their arrays are threaded as traced jit
        arguments (Simulation._consts) rather than baked constants.
        """
        op = op if op is not None else self.op
        if self.cfg.method == "dctcg":
            hc = dctcg_consts if dctcg_consts is not None \
                else self.dctcg_consts
            return self._mapped(b, p0, op.diag, op.code, hc)
        if self.cfg.method in ("mg", "mgcg"):
            ops = mg_ops if mg_ops is not None else self._mg.ops
            levels = tuple((o.diag, o.code) for o in ops)
        else:
            levels = ()
        return self._mapped(b, p0, op.diag, op.code, levels)
