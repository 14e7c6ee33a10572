"""SIMP density-field evaluation (counterpart of
examples/simp_density_eval.py; the reference's second integration case,
test/runtests.jl:51-89) plus a sweep of thresholded designs.

    python -m topopteval_tpu_torch.examples.simp_density_eval [mesh.vtu]
        [--device cpu] [--out-dir DIR]

The sweep is one batched call, ``evaluate_design_batch`` (every
thresholded design one block-Jacobi PCG lane), in float64: at the SIMP
contrast of 1e-8 a float32 lane cannot reach the relative tolerance of
1e-8.
"""

import os

import numpy as np
import torch

import topopteval_tpu_torch as tt

from . import parser


def main(argv=None) -> dict:
    args = parser("simp_density_eval", __doc__.splitlines()[0],
                  "beam_vfrac_04_Raw.vtu").parse_args(argv)
    mesh = tt.import_mesh(args.mesh)
    density = tt.extract_cell_density(args.mesh)
    volume = tt.calculate_volume(mesh, density, device=args.device)
    tt.print_info(f"Weighted volume: {volume:.3f}")

    material = tt.create_simp_material_model(1.0, 0.3, Emin=1e-8, p=3.0)
    problem = tt.setup_problem(mesh, device=args.device)
    tt.assemble_stiffness_matrix_simp(problem, material, density)
    tt.apply_fixed_boundary(problem, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(problem, tt.nodes_at_plane(mesh, 0, 60.0),
                   [0.0, 0.0, -1.0])

    result = tt.solve_system_simp(problem)
    tt.print_success(f"Energy: {result.energy:.6f} J; max von Mises "
                     f"{result.max_von_mises:.4f}")
    out = os.path.join(args.out_dir, "cantilever_beam-raw")
    stress = tt.export_results(result, problem, out)

    # design sweep: threshold the field at several cutoffs and compare
    cutoffs = np.linspace(0.1, 0.7, 4)
    batch = np.stack([np.where(density > c, density, 0.0) for c in cutoffs])
    energies, iters, conv = tt.evaluate_design_batch(
        problem, batch, tol=1e-8, maxiter=20000, dtype=torch.float64)
    for c, e in zip(cutoffs, energies[:, 0]):
        tt.print_data(f"  void cutoff {c:.2f}: compliance {e:.4f}")
    return {"volume": volume, "energy": result.energy,
            "max_von_mises": result.max_von_mises, "method": result.method,
            "cutoffs": cutoffs.tolist(),
            "sweep_energies": energies[:, 0].tolist(),
            "sweep_iterations": iters[:, 0].tolist(),
            "sweep_converged": bool(conv.all()),
            "files": [out + "_u.vtu", stress]}


if __name__ == "__main__":
    main()
