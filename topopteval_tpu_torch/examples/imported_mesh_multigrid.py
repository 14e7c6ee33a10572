"""Imported-mesh multigrid workflow (counterpart of
examples/imported_mesh_multigrid.py): the reference's core use case, any
mesh through one solve entry (FiniteElementAnalysis.jl:547), on the
multigrid route.

    python -m topopteval_tpu_torch.examples.imported_mesh_multigrid
        [--device cpu]

It loads the bundled topology-optimised Tet4 beam, selects the clamped and
loaded ends geometrically and solves twice: by the direct solve, the
answer for a mesh this small, and with
``SolverConfig(preconditioner="multigrid")``, which builds the block-ELL
hierarchy for an imported mesh (fem/bell.py; ``TOPOPT_MG=galerkin``
selects the Galerkin voxel hierarchy instead) and runs MG-PCG.  It checks
the JAX example's own bars for this porous geometry: the multigrid solve
converges within 500 iterations at tolerance 1e-8, and its energy lies
within 2e-2 of the direct one.  The problem is float64: in float32 the
route refines in float64 and takes 572 iterations on the CPU, past the
example's 500.
"""

import os

import torch

import topopteval_tpu_torch as tt

from . import DATA, parser


def main(argv=None) -> dict:
    args = parser("imported_mesh_multigrid",
                  __doc__.splitlines()[0]).parse_args(argv)
    mesh = tt.import_mesh(os.path.join(DATA, "beam_linear_volume_mesh.vtu"))
    tt.calculate_volume(mesh, device=args.device)

    lam, mu = tt.create_material_model(1.0, 0.3)
    problem = tt.setup_problem(mesh, dtype=torch.float64,
                               device=args.device)
    tt.assemble_stiffness_matrix(problem, lam, mu)

    fixed = tt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6)
    loaded = tt.select_nodes_by_plane(mesh, [60, 0, 0], [1, 0, 0], 1e-6)
    tt.apply_fixed_boundary(problem, fixed)
    tt.apply_force(problem, loaded, [0.0, 0.0, -1.0])

    direct = tt.solve_system(problem, tt.SolverConfig(method="direct",
                                                      verbose=False))
    tt.print_data(f"direct           : energy {direct.energy:.9e}, "
                  f"max von Mises {direct.max_von_mises:.4f}")

    config = tt.SolverConfig(method="cg", preconditioner="multigrid",
                             tolerance=1e-8, max_iterations=500,
                             verbose=False)
    result = tt.solve_system(problem, config)
    rel = abs(result.energy - direct.energy) / abs(direct.energy)
    tt.print_data(f"multigrid PCG    : {result.iterations} iterations "
                  f"(converged={result.converged}), rel energy err "
                  f"{rel:.2e}")
    if not result.converged:
        raise RuntimeError("the multigrid solve did not converge")
    if rel >= 2e-2:
        raise RuntimeError(f"multigrid energy off the direct solve by "
                           f"{rel:.2e}")
    return {"direct_energy": direct.energy, "energy": result.energy,
            "rel_err": rel, "iterations": result.iterations,
            "converged": result.converged,
            "refinement_passes": result.refinement_passes}


if __name__ == "__main__":
    main()
