"""topopteval_tpu_torch — PyTorch/CUDA port of topopteval_tpu.

Strain-energy evaluation of topology-optimized structures: VTU, GMSH
and Abaqus .inp mesh import, linear-elastic FEM with SIMP density penalization, a matrix-free
stiffness operator whose element applies are hand-written CUDA kernels
(csrc/), block-Jacobi PCG with float64 dots and float64-certified
mixed-precision refinement, geometric multigrid PCG on generated boxes
over a hand-written stencil kernel, block-ELL (Galerkin voxel-chain)
multigrid PCG on any other mesh over hand-written block-sparse kernels
(or, with ``TOPOPT_MG=galerkin``, the probed Galerkin voxel hierarchy over
hand-written scan-window ELL kernels), the robust solver ladder (MINRES,
BiCGSTAB, GMRES, plain-CG and direct fallbacks, verbose diagnostics),
nodal, volume (gravity) and
surface-traction loads, stress recovery and VTU export, and batched design
sweeps (``evaluate_design_batch``: a density batch times load cases as
block-Jacobi PCG lanes).  Two probes of
kernel variants (``tools.ke_probe``, ``tools.ell_ablate``) and the four
workflow examples (``examples.*``) run as ``python -m`` modules.

The public names mirror ``topopteval_tpu``'s facade, so each function
has a counterpart of the same name there.  Entry points take an explicit
``device`` (default ``"cuda"``, which must exist); the package imports
neither JAX nor ``topopteval_tpu``.
"""

__version__ = "0.1.0"

# data model
from .mesh import DeviceMesh, Mesh, dofs_of_nodes, element_dofs

# mesh I/O
from .api import calculate_volume, extract_cell_density, import_mesh
from .io import (VTUWriter, inp_to_vtu, read_cell_density, read_inp_mesh,
                 read_msh_mesh, read_vtu_mesh, write_vtu)
from .io.results import (export_boundary_conditions, export_displacement,
                         export_results, export_stress)

# materials
from .materials import (SIMPMaterial, create_material_model,
                        create_simp_material_model, elasticity_matrix,
                        lame_parameters)

# problem workflow
from .api import (Problem, SolveResult, apply_fixed_boundary, apply_force,
                  apply_sliding_boundary, assemble_stiffness_matrix,
                  assemble_stiffness_matrix_simp, evaluate_design_batch,
                  load_result, problem_from_numpy, save_result,
                  setup_problem, solve_system, solve_system_adaptive,
                  solve_system_robust, solve_system_robust_simp,
                  solve_system_simp)

# boundary selection
from .fem.bc import (DirichletBC, extract_surface, free_mask_from_bcs,
                     nodes_at_plane, select_nodes_by_circle,
                     select_nodes_by_plane, select_nodes_by_set)

# loads (reference: VolumeForce + SurfaceTraction)
from .fem.loads import (apply_acceleration, apply_gravity,
                        apply_surface_traction,
                        apply_uniform_surface_traction,
                        apply_variable_density_volume_force,
                        apply_volume_force, compute_boundary_area,
                        get_boundary_facets)

# solver config
from .config import (SolverConfig, adaptive_config, large_general_config,
                     large_symmetric_config, memory_efficient_config)

# mesh generators and canonical problems
from .models import (cantilever_beam, cantilever_under_gravity,
                     cube_under_gravity, generate_grid_hex,
                     generate_grid_tet, refined_beam, simp_beam)

# geometric multigrid: structured boxes, Galerkin voxel hierarchy
from .fem.multigrid import (MultigridPreconditioner,
                            build_structured_multigrid,
                            build_unstructured_multigrid)
from .fem.structured import StructuredStiffnessOperator

# terminal helpers
from .utils import (print_data, print_error, print_info, print_success,
                    print_warning, set_verbosity)

__all__ = [
    "Mesh", "DeviceMesh", "dofs_of_nodes", "element_dofs",
    "import_mesh", "extract_cell_density", "calculate_volume",
    "read_vtu_mesh", "read_cell_density", "write_vtu", "VTUWriter",
    "read_msh_mesh", "read_inp_mesh", "inp_to_vtu",
    "export_results", "export_displacement", "export_stress",
    "export_boundary_conditions",
    "create_material_model", "create_simp_material_model",
    "lame_parameters", "SIMPMaterial", "elasticity_matrix",
    "Problem", "SolveResult", "setup_problem", "problem_from_numpy",
    "assemble_stiffness_matrix", "assemble_stiffness_matrix_simp",
    "apply_fixed_boundary", "apply_sliding_boundary", "apply_force",
    "solve_system", "solve_system_simp", "solve_system_adaptive",
    "solve_system_robust", "solve_system_robust_simp", "save_result",
    "load_result", "evaluate_design_batch",
    "select_nodes_by_plane", "select_nodes_by_circle",
    "select_nodes_by_set", "nodes_at_plane",
    "extract_surface", "DirichletBC", "free_mask_from_bcs",
    "apply_volume_force", "apply_gravity", "apply_acceleration",
    "apply_variable_density_volume_force", "get_boundary_facets",
    "compute_boundary_area", "apply_surface_traction",
    "apply_uniform_surface_traction",
    "SolverConfig", "large_symmetric_config", "large_general_config",
    "memory_efficient_config", "adaptive_config",
    "generate_grid_hex", "generate_grid_tet", "refined_beam",
    "cantilever_beam", "simp_beam", "cantilever_under_gravity",
    "cube_under_gravity",
    "StructuredStiffnessOperator", "build_structured_multigrid",
    "build_unstructured_multigrid", "MultigridPreconditioner",
    "print_info", "print_error", "print_warning", "print_success",
    "print_data", "set_verbosity",
]
