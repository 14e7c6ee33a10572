"""Self-weight validation against Euler-Bernoulli (counterpart of
examples/gravity_validation.py; the reference's manual analytical test,
test/VolumeForces/testVolumeForces.jl:6-60).

    python -m topopteval_tpu_torch.examples.gravity_validation
        [--device cpu]
"""

import numpy as np

import topopteval_tpu_torch as tt

from . import parser


def main(argv=None) -> dict:
    args = parser("gravity_validation",
                  __doc__.splitlines()[0]).parse_args(argv)
    L, w, h = 10.0, 1.0, 1.0
    mesh = tt.generate_grid_hex(40, 8, 8, (0, 0, 0), (L, w, h))
    E, nu, rho, g = 200e9, 0.3, 7850.0, 9.81

    problem = tt.setup_problem(mesh, device=args.device)
    tt.assemble_stiffness_matrix(problem, *tt.create_material_model(E, nu))
    fixed = tt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-9)
    tt.apply_fixed_boundary(problem, fixed)
    tt.apply_gravity(problem, rho, g, [0.0, 0.0, -1.0])

    result = tt.solve_system(problem)

    I = w * h ** 3 / 12
    analytical = rho * g * L ** 4 / (8 * E * I)
    numerical = float(np.max(np.abs(result.u.reshape(-1, 3)[:, 2])))
    err = abs(numerical - analytical) / analytical * 100

    tt.print_data("=" * 60)
    tt.print_data("CANTILEVER BEAM RESULTS COMPARISON")
    tt.print_data("=" * 60)
    tt.print_data(f"Analytical deflection: {analytical:.6e} m")
    tt.print_data(f"Numerical deflection:  {numerical:.6e} m")
    tt.print_data(f"Relative error:        {err:.2f} %")
    if err < 5.0:
        tt.print_success("Results match analytical solution (error < 5%)")
    else:
        tt.print_warning("error >= 5%, refine the mesh")
    return {"analytical": analytical, "numerical": numerical,
            "error_percent": err, "total_force": problem.f.reshape(-1, 3)
            .sum(axis=0).tolist(), "energy": result.energy,
            "method": result.method}


if __name__ == "__main__":
    main()
