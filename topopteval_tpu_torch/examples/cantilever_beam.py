"""Linear cantilever beam workflow (counterpart of
examples/cantilever_beam.py; the reference's first integration case,
test/runtests.jl:21-49).

    python -m topopteval_tpu_torch.examples.cantilever_beam [mesh.vtu]
        [--device cpu] [--out-dir DIR]
"""

import os

import topopteval_tpu_torch as tt

from . import parser


def main(argv=None) -> dict:
    args = parser("cantilever_beam", __doc__.splitlines()[0],
                  "beam_linear_volume_mesh.vtu").parse_args(argv)
    mesh = tt.import_mesh(args.mesh)
    volume = tt.calculate_volume(mesh, device=args.device)
    tt.print_info(f"Mesh volume: {volume:.3f}")

    lam, mu = tt.create_material_model(1.0, 0.3)
    problem = tt.setup_problem(mesh, device=args.device)
    tt.assemble_stiffness_matrix(problem, lam, mu)

    fixed = tt.nodes_at_plane(mesh, 0, 0.0)
    loaded = tt.nodes_at_plane(mesh, 0, 60.0)
    tt.apply_fixed_boundary(problem, fixed)
    tt.apply_force(problem, loaded, [0.0, 0.0, -1.0])

    result = tt.solve_system(problem)
    tt.print_success(f"Energy: {result.energy:.6f} J; max von Mises "
                     f"{result.max_von_mises:.4f} at cell "
                     f"{result.max_stress_cell} "
                     f"({result.iterations} iterations of {result.method}, "
                     f"{result.solve_time:.2f}s)")

    out = os.path.join(args.out_dir, "cantilever_beam-linear")
    stress = tt.export_results(result, problem, out)
    bc = tt.export_boundary_conditions(mesh, fixed, loaded, out + "_bc")
    return {"volume": volume, "energy": result.energy,
            "max_von_mises": result.max_von_mises, "method": result.method,
            "files": [out + "_u.vtu", stress, bc]}


if __name__ == "__main__":
    main()
