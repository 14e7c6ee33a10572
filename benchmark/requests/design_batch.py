"""Request kind ``design_batch``: each request is a batch of fresh SIMP
density fields times the mix's fixed tip loads, one
``api.evaluate_design_batch`` call, every (density, load) pair a lane.
Set-up builds the box and runs one batch of its own for a few iterations,
so every shape of the lanes' first steps has run once."""

from __future__ import annotations

import numpy as np

from benchmark.core import generator as gen
from benchmark.core.meshgen import box_mesh, plane_nodes
from benchmark.reference import control
from benchmark.reference.elasticity import Tet4Reference
from benchmark.reference.judge import free_mask, judge_lanes, lame_lanes


class Client:

    def __init__(self, ctx):
        self.ctx, self.tt, self.torch = ctx, ctx.tt, ctx.torch
        self.cfg, self.mix = ctx.cfg, ctx.mix
        m = self.cfg["mesh"]
        self.coords, self.conn = box_mesh(m)
        self.clamped = plane_nodes(self.coords, 0, m["lo"][0])
        tip = plane_nodes(self.coords, 0, m["hi"][0])
        n_dofs = 3 * len(self.coords)
        self.loads = np.stack([gen.tip_load(n_dofs, tip, v)
                               for v in self.mix["loads"]])
        self.sizes = {"n_cells": len(self.conn), "n_nodes": len(self.coords),
                      "itemsize": 4 if self.cfg["solver"]["dtype"] ==
                      "float32" else 8}
        self.problem = None

    def setup(self):
        tt = self.tt
        mat = self.cfg["material"]
        self.material = tt.SIMPMaterial(
            E0=mat["E0"], nu=mat["nu"], Emin=mat["Emin"], p=mat["p"])
        mesh = tt.Mesh(self.coords, self.conn, "tet4")
        s = self.cfg["solver"]
        self.problem = tt.setup_problem(
            mesh, dtype=getattr(self.torch, s["dtype"]),
            device=self.ctx.device)
        tt.apply_fixed_boundary(self.problem, self.clamped)
        self._batch(self.densities(gen.SETUP, 0), maxiter=s["warm_steps"])

    def densities(self, stream: int, index: int) -> np.ndarray:
        return gen.densities(self.mix["density"], len(self.conn),
                             self.mix["densities"],
                             gen.rng(self.ctx.seed, stream, index))

    def _batch(self, dens, maxiter, tol=None):
        s = self.cfg["solver"]
        return self.tt.evaluate_design_batch(
            self.problem, dens, self.loads, material=self.material,
            tol=s["tolerance"] if tol is None else tol, maxiter=maxiter)

    def inputs(self, i):
        """(densities [B, C], loads [L, ndof]) of request ``i``."""
        return self.densities(gen.REQUEST, i), self.loads

    def request(self, i, tol=None):
        dens, _ = self.inputs(i)
        with self.torch.profiler.record_function("bench.batch"):
            e, it, cv = self._batch(dens, self.cfg["solver"]["max_iterations"],
                                    tol)
        return {"energies": np.asarray(e, np.float64),
                "iterations": np.asarray(it), "converged": np.asarray(cv),
                "densities": dens}

    def describe(self, rec) -> str:
        it = rec["iterations"]
        return (f"lanes={it.size} iterations median={float(np.median(it))} "
                f"max={int(it.max())} converged="
                f"{int(rec['converged'].sum())}")

    def attempted(self, records) -> int:
        return sum(r["energies"].size for r in records)

    def release(self):
        self.problem = None

    def judge(self, records):
        """``lane_err`` of a sample of the window's lanes drawn from the
        seed, the lane that took the most iterations among them, against
        the reference's own solves; and the count of lanes that did not
        converge."""
        torch = self.torch
        L = self.loads.shape[0]
        lanes = [(r, b, j) for r in range(len(records))
                 for b in range(records[r]["energies"].shape[0])
                 for j in range(L)]
        its = np.array([records[r]["iterations"][b, j] for r, b, j in lanes])
        g = gen.rng(self.ctx.seed, gen.SAMPLE)
        n = min(len(lanes), int(self.mix["judged_lanes"]))
        pick = [int(np.argmax(its))]
        rest = [k for k in g.permutation(len(lanes)) if k != pick[0]]
        pick += [int(k) for k in rest[: n - 1]]
        sel = [lanes[k] for k in pick]
        ref = Tet4Reference(self.coords, self.conn, self.ctx.device)
        m = free_mask(len(self.coords), self.clamped, ref.device)
        lam, mu = lame_lanes(np.stack([records[r]["densities"][b]
                                       for r, b, _ in sel]),
                             self.cfg["material"], ref.device)
        errs = judge_lanes(ref, lam, mu, m,
                           self.loads[[j for _, _, j in sel]],
                           np.array([records[r]["energies"][b, j]
                                     for r, b, j in sel]))
        failed = int(sum((~r["converged"]).sum() for r in records))
        worst = max(e if np.isfinite(e) else np.inf for e in errs)
        for r in records:
            r.pop("densities")
        del ref
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"lane_err": float(worst)}, failed

    def control(self, spec: dict):
        """(numbers under the cell's names, notes) of one control on the
        inputs of request 0:

        - ``precision``: the reference's PCG in bfloat16 in the program's
          place, on as many lanes as a run judges;
        - ``tolerance``: the program itself with its stopping tolerance
          ``scale`` times the configuration's (the guarantee broken),
          judged like a run."""
        s = self.cfg["solver"]
        if spec["kind"] == "tolerance":
            self.setup()
            rec = self.request(0, tol=s["tolerance"] * spec["scale"])
            self.release()
            its = int(rec["iterations"].max())
            checks, failed = self.judge([rec])
            return checks, {"failed": failed, "iterations_max": its}
        dens, loads = self.inputs(0)
        n = int(self.mix["judged_lanes"])
        (B, L), lanes = (dens.shape[0], loads.shape[0]), range(n)
        errs, notes = control.lane_control(
            self.coords, self.conn, self.clamped,
            dens[[k % B for k in lanes]], self.cfg["material"],
            loads[[k % L for k in lanes]], s["tolerance"],
            s["max_iterations"], self.ctx.device)
        return {"lane_err": float(max(errs))}, notes
