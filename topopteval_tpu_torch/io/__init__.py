from .vtu import (VTUWriter, read_cell_density, read_vtu_mesh, write_vtu,
                  write_vtu_heterogeneous)
from .gmsh import read_msh_mesh
from .inp import (inp_to_vtu, inspect_inp_elements, parse_inp,
                  read_inp_mesh, validate_inp_file)
