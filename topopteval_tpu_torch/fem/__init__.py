from .bc import (DirichletBC, extract_surface, free_mask_from_bcs,
                 nodes_at_plane, select_nodes_by_plane)
from .operator import StiffnessOperator, assemble_scipy
from .solvers import (KrylovResult, apply_preconditioner,
                      block_jacobi_preconditioner, cg, direct_solve,
                      jacobi_preconditioner)
from .multigrid import (MultigridPreconditioner, build_structured_multigrid,
                        build_unstructured_multigrid)
