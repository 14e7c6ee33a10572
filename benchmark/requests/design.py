"""Request kind ``design``: each request is a new SIMP density field on
the same imported mesh, assembled (``api.assemble_stiffness_matrix_simp``)
and solved (``api.solve_system``) for its energy and stresses.  Set-up
imports the mesh and runs one design of its own, so the program's
density-independent work (the block-ELL skeleton, the kernels) is ready
and every request pays the value pass and the solve."""

from __future__ import annotations

import numpy as np

from benchmark.core import generator as gen
from benchmark.requests._beam import BeamClient


class Client(BeamClient):

    def inputs(self, i):
        """(density, tip resultant) of request ``i``; None: set-up's.
        The resultant is the same for every request."""
        density = (self.density(gen.SETUP) if i is None
                   else self.density(gen.REQUEST, i))
        return density, np.asarray(self.mix["load"], np.float64)

    def setup(self):
        self.build_problem()
        self.tt.apply_force(self.problem, self.tip, self.mix["load"])
        self.request(None)

    def request(self, i):
        density, vector = self.inputs(i)
        with self.torch.profiler.record_function("bench.assemble"):
            self.tt.assemble_stiffness_matrix_simp(self.problem,
                                                   self.material, density)
        with self.torch.profiler.record_function("bench.solve"):
            return self.solve(density, self.load(vector))
