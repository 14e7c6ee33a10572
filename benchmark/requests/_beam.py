"""What the beam request kinds share: the imported mesh, the problem with
its clamp and SIMP material, one solve through ``api.solve_system``, and
the reference's judgement of every solve of the window."""

from __future__ import annotations

import os

import numpy as np

from benchmark.core import generator as gen
from benchmark.core.meshgen import box_mesh, plane_nodes, write_vtu
from benchmark.reference import control
from benchmark.reference.elasticity import Tet4Reference
from benchmark.reference.judge import free_mask, judge_solution, lame_lanes


class BeamClient:
    """Set-up common to the beam cells; subclasses add ``request``."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.tt, self.torch = ctx.tt, ctx.torch
        self.cfg, self.mix = ctx.cfg, ctx.mix
        m = self.cfg["mesh"]
        self.coords, self.conn = box_mesh(m)
        self.clamped = plane_nodes(self.coords, 0, m["lo"][0])
        self.tip = plane_nodes(self.coords, 0, m["hi"][0])
        self.n_dofs = 3 * len(self.coords)
        self.sizes = {"n_cells": len(self.conn), "n_nodes": len(self.coords)}
        self.problem = None
        self.timings = {}          # the previous solve's

    def build_problem(self):
        """The mesh written to .vtu under the run's temporary directory,
        imported back (so it carries no generator provenance and takes
        the imported-mesh routes), a problem with its clamp, the SIMP
        material and the solver's settings."""
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
        p = tt.setup_problem(mesh, dtype=getattr(self.torch,
                                                 self.cfg["solver"]["dtype"]),
                             device=self.ctx.device)
        tt.apply_fixed_boundary(p, self.clamped)
        self.problem = p

    def density(self, stream: int, index: int = 0) -> np.ndarray:
        return gen.design(self.mix["design"], self.cfg["mesh"],
                          gen.rng(self.ctx.seed, stream, index))

    def load(self, vector) -> np.ndarray:
        return gen.tip_load(self.n_dofs, self.tip, vector)

    def solve(self, density: np.ndarray, load: np.ndarray) -> dict:
        """One solve, and what the reference and the metrics read of it."""
        r = self.tt.solve_system(self.problem, self.solver)
        before, self.timings = self.timings, dict(r.timings or {})
        return {"energy": float(r.energy), "u": np.asarray(r.u, np.float64),
                "vm": np.asarray(r.von_mises), "iterations": int(r.iterations),
                "passes": int(r.refinement_passes),
                "converged": bool(r.converged), "method": r.method,
                "timings": self.timings, "timings_before": before,
                "density": density, "load": load}

    def describe(self, rec) -> str:
        t = rec["timings"]
        return (f"iterations={rec['iterations']} passes={rec['passes']} "
                f"converged={rec['converged']} method={rec['method']} "
                f"build_operator={t.get('build_operator', 0.0):.3f} "
                f"refine_host_matvec="
                f"{t.get('refine_host_matvec_seconds', 0.0):.3f} "
                f"postprocess={t.get('postprocess', 0.0):.3f}")

    def attempted(self, records) -> int:
        return len(records)

    def release(self):
        self.problem = None

    def judge(self, records):
        """Worst reading of each number over every solve of the window,
        and the count of solves that did not converge."""
        torch = self.torch
        ref = Tet4Reference(self.coords, self.conn, self.ctx.device)
        m = free_mask(len(self.coords), self.clamped, ref.device)
        worst = {"resid": 0.0, "energy_gap": 0.0, "vm_gap": 0.0}
        failed = 0
        for rec in records:
            lam, mu = lame_lanes(rec["density"][None], self.cfg["material"],
                                 ref.device)
            got = judge_solution(ref, lam, mu, m, rec["load"], rec["u"],
                                 rec["energy"], rec["vm"])
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
        density, vector = self.inputs(0)
        s = self.cfg["solver"]
        return control.beam_control(self.coords, self.conn, self.clamped,
                                    density, self.cfg["material"],
                                    self.load(vector), s["tolerance"],
                                    s["max_iterations"], self.ctx.device)
