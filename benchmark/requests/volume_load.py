"""Request kind ``volume_load``: one design, drawn from the seed at set-up,
on the imported mesh raised to the configuration's interpolation order
(``api.setup_problem(interpolation_order=...)``), under its own weight in
a new direction a request: the mix's fixed set of directions cycled in an
order drawn from the seed, the problem's load reset and the
density-weighted body force applied
(``api.apply_variable_density_volume_force``), then
``api.solve_system``.  Set-up imports the mesh, raises its order, clamps
every node of the x = lo plane that the program's own quadratic mesh has
there (mid-edge nodes included), solves once, so the design's multigrid
hierarchy exists and no request builds one, and exports that solve's
displacements to .vtu once, outside the timed window.  A program whose
set-up solve does not converge cannot run the cell: set-up raises, and
the run ends with no result line.

The reference (reference/tet10.py) builds its own quadratic mesh from the
benchmark's linear one and finds the program's nodes among its own by
their coordinates; it computes the load itself from the design and the
request's direction."""

from __future__ import annotations

import os

import numpy as np

from benchmark.core import generator as gen
from benchmark.core.meshgen import plane_nodes, write_vtu
from benchmark.reference.control_tet10 import tet10_control
from benchmark.reference.judge import free_mask, judge_solution, lame_lanes
from benchmark.reference.tet10 import Tet10Reference, match_nodes, tet10_mesh
from benchmark.requests.load_case import Client as LoadCaseClient


class Client(LoadCaseClient):

    def build_problem(self):
        """The linear mesh written to .vtu and imported back, its order
        raised by ``setup_problem``, the clamp taken from the program's
        own nodes, the SIMP material and the solver's settings."""
        tt = self.tt
        mat = self.cfg["material"]
        self.material = tt.SIMPMaterial(
            E0=mat["E0"], nu=mat["nu"], Emin=mat["Emin"], p=mat["p"])
        s = self.cfg["solver"]
        self.solver = tt.SolverConfig(
            method=s["method"], preconditioner=s["preconditioner"],
            tolerance=s["tolerance"], max_iterations=s["max_iterations"],
            verbose=False)
        path = write_vtu(os.path.join(self.ctx.tmp, "mesh.vtu"),
                         self.coords, self.conn)
        mesh = tt.import_mesh(path)
        os.remove(path)
        p = tt.setup_problem(
            mesh, interpolation_order=int(self.cfg["interpolation_order"]),
            dtype=getattr(self.torch, s["dtype"]), device=self.ctx.device)
        self.nodes = np.array(p.mesh.coords, np.float64)
        self.clamped = plane_nodes(self.nodes, 0, self.cfg["mesh"]["lo"][0])
        tt.apply_fixed_boundary(p, self.clamped)
        self.n_dofs = p.n_dofs
        self.sizes = {"n_cells": p.mesh.n_cells, "n_nodes": p.mesh.n_nodes}
        self.problem = p

    def setup(self):
        self.build_problem()
        self.design = self.density(gen.SETUP)
        self.tt.assemble_stiffness_matrix_simp(self.problem, self.material,
                                               self.design)
        rec = self.request(None)
        if not rec["converged"]:
            raise RuntimeError(
                "the set-up solve is not certified: this program cannot "
                "run the configuration")
        path = self.tt.export_results(
            rec["u"], self.problem, os.path.join(self.ctx.tmp, "u.vtu"))
        os.remove(path)

    def request(self, i):
        vector = self.vector(i)
        with self.torch.profiler.record_function("bench.load"):
            self.problem.f = np.zeros(self.n_dofs)
            self.tt.apply_variable_density_volume_force(
                self.problem, list(vector), self.design)
        # the call's own timings; the parent of this cell has none
        load_timings = dict(getattr(self.problem, "load_timings", None)
                            or {})
        with self.torch.profiler.record_function("bench.solve"):
            rec = self.solve(self.design, vector)
        rec["load_timings"] = load_timings
        return rec

    def describe(self, rec) -> str:
        return (super().describe(rec) + " volume_force="
                f"{rec['load_timings'].get('volume_force', 0.0):.3f}")

    def _reference(self):
        """(the reference's Tet10 coordinates and connectivity, its clamped
        nodes)."""
        coords, conn = tet10_mesh(self.coords, self.conn)
        return coords, conn, plane_nodes(coords, 0,
                                         self.cfg["mesh"]["lo"][0])

    def judge(self, records):
        """Worst reading of each number over every solve of the window,
        and the count of solves that did not converge: the program's
        displacements moved onto the reference's nodes, the load the
        reference's own."""
        torch = self.torch
        coords, conn, clamped = self._reference()
        ref = Tet10Reference(coords, conn, self.ctx.device)
        ours = match_nodes(coords, self.nodes)
        m = free_mask(len(coords), clamped, ref.device)
        worst = {"resid": 0.0, "energy_gap": 0.0, "vm_gap": 0.0}
        failed = 0
        for rec in records:
            lam, mu = lame_lanes(rec["density"][None], self.cfg["material"],
                                 ref.device)
            u = np.zeros((len(coords), 3))
            u[ours] = rec["u"].reshape(-1, 3)
            got = judge_solution(ref, lam, mu, m,
                                 ref.body_force(rec["load"], rec["density"]),
                                 u.reshape(-1), rec["energy"], rec["vm"])
            rec["checks"] = got
            for k, v in got.items():
                worst[k] = max(worst[k], v if np.isfinite(v) else np.inf)
            failed += not rec["converged"]
            for big in ("u", "vm", "density", "load"):
                rec.pop(big)
        del ref
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return worst, failed

    def control(self, spec: dict):
        """(numbers under the cell's names, notes) of the ``precision``
        control on the inputs of request 0: the reference's float32 solve
        at the configuration's tolerance and step limit, its energy in
        float32 and its stresses in bfloat16, in the program's place."""
        assert spec["kind"] == "precision", spec
        coords, conn, clamped = self._reference()
        s = self.cfg["solver"]
        return tet10_control(coords, conn, clamped, self.density(gen.SETUP),
                             self.cfg["material"], self.vector(0),
                             s["tolerance"], s["max_iterations"],
                             self.ctx.device)
