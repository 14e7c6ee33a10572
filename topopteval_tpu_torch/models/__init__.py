from .beams import generate_grid_hex, generate_grid_tet, refined_beam
from .density import (bench_simp_density, sample_cell_density,
                      vfrac04_density_for)
from .problems import (cantilever_beam, cantilever_under_gravity,
                       cube_under_gravity, simp_beam)
