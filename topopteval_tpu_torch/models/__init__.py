from .beams import generate_grid_hex, generate_grid_tet, refined_beam
from .density import sample_cell_density, vfrac04_density_for
from .problems import cantilever_beam, simp_beam
