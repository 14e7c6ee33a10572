"""Request kind ``load_case``: one design, drawn from the seed at set-up,
under a new load case a request: a tip resultant in one of the mix's
fixed directions, in an order drawn from the seed, the problem's load
reset and applied (``api.apply_force``),
then ``api.solve_system``.  Set-up imports the mesh and solves once, so
the design's multigrid hierarchy exists and no request builds one."""

from __future__ import annotations

import numpy as np

from benchmark.core import generator as gen
from benchmark.requests._beam import BeamClient


class Client(BeamClient):

    def inputs(self, i):
        """(density, tip resultant) of request ``i``; None: set-up's.
        The density is the same for every request of a run."""
        return self.density(gen.SETUP), self.vector(i)

    def vector(self, i):
        """Request ``i``'s tip resultant: the mix's fixed set of
        directions, cycled in an order drawn from the seed (set-up takes
        request 0's)."""
        dirs = gen.direction_set(int(self.mix["directions"]))
        order = gen.rng(self.ctx.seed, gen.REQUEST).permutation(len(dirs))
        return self.mix["magnitude"] * dirs[order[(i or 0) % len(dirs)]]

    def setup(self):
        self.build_problem()
        self.design = self.density(gen.SETUP)
        self.tt.assemble_stiffness_matrix_simp(self.problem, self.material,
                                               self.design)
        self.request(None)

    def request(self, i):
        vector = self.vector(i)
        with self.torch.profiler.record_function("bench.load"):
            self.problem.f = np.zeros(self.n_dofs)
            self.tt.apply_force(self.problem, self.tip, list(vector))
        with self.torch.profiler.record_function("bench.solve"):
            return self.solve(self.design, self.load(vector))
