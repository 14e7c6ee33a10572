#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (topopteval_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root.  Phases, each printed as one line (or a
few) and each failing the script on a failed check:

1. device: the card's name and power limit (nvidia-smi), the kernel build;
2. kernel parity: every CUDA kernel against its plain PyTorch version on
   the card, in float64 and float32, at the shapes of the real-size run;
3. the two bundled fixtures through import → setup → assemble → BCs →
   forced block-Jacobi CG → export, against the port's fp64 host direct
   oracle (SIMP Hex8 beam in float32, Tet4 cantilever in float64);
4. the 153,600-tet cantilever written to .vtu, read back and solved with
   the default ``solve_system`` (auto picks CG above 50k DOFs), in
   float64 against data/oracle_energies.json and in float32 through the
   refinement route;
5. kernel times (CUDA events over a replayed CUDA graph: device time)
   beside their bound, the plain version (eager) and a ``torch.bmm`` of a
   precomputed Ke batch as library yardstick; ``eager_ms`` is the kernel
   called from Python, wrapper checks included;
6. where one CG iteration on the real-size beam spends its time: the
   parts timed alone, the host wall time per iteration and the device's
   busy share under ``torch.profiler``;
7. the structured-multigrid route (``preconditioner="multigrid"``) on
   generated beams: both stencil kernels against their plain version at
   three shapes, the float32 energy of a converged solution through the
   stencil, then scales 4, 8 and 16 (1,228,800 tets, 666,315 DOFs) in
   float64 against data/oracle_energies.json, scale 8 once more through
   the opt-in ``window`` kernel, a per-hex SIMP scale-4 beam against the
   host direct oracle, and scale 16 in float32 through the refinement
   route; the stencil kernels' times beside their bound, the plain
   version and a two-``conv3d`` library yardstick; and where one MG-PCG
   iteration at scale 16 spends its time;
8. the block-ELL multigrid route on meshes without ``structured_info``:
   the 1,228,800-tet beam written to .vtu and read back, solved in float32
   (hi/lo system operator, bf16 V-cycle copies, float64 refinement)
   against data/oracle_energies.json; both block-ELL kernels against their
   plain versions at that beam's fine-operator and transfer shapes, on a
   coarse Galerkin level and on a random matrix with empty rows; the lo
   plane's effect; the scale-8 beam uniform (float64, through the disk
   cache and back) and with the benchmark SIMP density (float64, the
   skeleton from the in-process cache; its energy held to twice the
   distance from the oracle of float64 direct solves of the same system
   under two column orders); the SIMP Hex8 fixture in float32
   against the host direct oracle; the kernels' times beside their bound,
   the plain version and a cuSPARSE yardstick; and where one MG-PCG
   iteration at scale 16 spends its time.

The line before last is one JSON object with a record per kernel; the
last line is the run's contract line.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CG_KW = dict(method="cg", preconditioner="block_diagonal", tolerance=1e-10,
             max_iterations=20000, verbose=False)

# H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s fp32, 34 TFLOP/s fp64
# (non-tensor-core rates, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# floating-point operations per element that the function needs (add,
# sub, mul, div each 1), counted for its least formulation, not for the
# kernel's own algorithm:
#  tet4: edges x_k - x_0 9; cofactors of the edge matrix 27, det 5,
#    r = 1/(6 det) 2, lam r and mu r 2; du_k = u_k - u_0 9;
#    H = sum_k du_k (x) adj_k 45; sigma from H (tr 3, 2 mu 1, diagonal 6,
#    off-diagonal 6) 16; f_k = sigma adj_k for k = 1..3 45 and
#    f_0 = -(f_1 + f_2 + f_3) 6.  Total 166.
#  hex8, 2x2x2 Gauss: reference gradients of the 3 coordinate and the 3
#    displacement fields at all 8 points, sum-factorised over the 1-D
#    two-point rule, 108 each (648); per point the cofactors of J 27,
#    det 5, 1/det 1, lam/det and mu/det 2, H adj(J) 45, sigma 16 and
#    P = sigma adj(J)^T 45, 141 (1128 for 8 points); the transposed
#    sum-factorised reduction of P onto the nodes, 160 for each of the
#    3 components (480).  Total 2256.
#  stencil (per hex cell, through its 6 constant-gradient tets; each is a
#    Kuhn tet whose vertices follow three axis-parallel edges, so column i
#    of grad u is one edge difference over h_i): per tet the 3 edge
#    differences 9 and their scaling 9; sigma from grad u 16; one weight
#    vol*esc 1; the 3 scaled columns s_i = w sigma e_i / h_i 9; the nodal
#    forces -s_1, s_1 - s_2, s_2 - s_3, s_3 6; 12 adds onto the corners.
#    62 per tet, 372 per cell.
FLOPS_PER_ELEMENT = {"tet4_apply": 166, "hex8_apply": 2256,
                     "stencil_plane": 372, "stencil_window": 372}
REPLACES = {
    "tet4_apply": "topopteval_tpu/ops/pallas_kernels.py:137",
    "hex8_apply": "topopteval_tpu/ops/pallas_kernels.py:256",
    "stencil_plane": "topopteval_tpu/ops/pallas_stencil.py:156",
    "stencil_window": "topopteval_tpu/ops/pallas_stencil.py:97",
    "bell_matvec": "topopteval_tpu/ops/pallas_bsr.py:287",
    "sell_matvec": "topopteval_tpu/ops/pallas_bsr.py:399",
}
SOURCE = "topopteval_tpu_torch/csrc/element_apply.cu"
STENCIL_SOURCE = "topopteval_tpu_torch/csrc/stencil_apply.cu"
BELL_SOURCE = "topopteval_tpu_torch/csrc/bell_apply.cu"
# operations per stored entry that the block-ELL functions need: a 3x3
# block times a 3-vector added into 3 sums, 9 multiplies and 9 adds; a
# scalar weight times a 3-vector into 3 sums, 6
FLOPS_PER_BLOCK = {"bell_matvec": 18, "sell_matvec": 6}
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=500, verbose=False)
BEAM_BOX = (60.0, 20.0, 4.0)
TOLERANCE = {"float64": 1e-12, "float32": 1e-5}


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import _build
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem.operator import assemble_scipy
    from topopteval_tpu_torch.fem.solvers import direct_solve
    from topopteval_tpu_torch.ops import bell as bo
    from topopteval_tpu_torch.ops import element_kernels as ek
    from topopteval_tpu_torch.ops import stencil as st
    from topopteval_tpu_torch.ops.elements import element_stiffness

    tt.set_verbosity(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    CG = tt.SolverConfig(**CG_KW)
    kernel_fns = {"tet4_apply": (ek.tet4_apply, ek.tet4_apply_reference),
                  "hex8_apply": (ek.hex8_apply, ek.hex8_apply_reference)}
    main_path_launches = {name: 0 for name in (*kernel_fns, *st.LAUNCHES,
                                               *bo.LAUNCHES)}

    # -- 1. device + build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{n}.cu {s:.1f} s" for n, s in built.items()),
          flush=True)
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")

    # -- 2. kernel parity at the real-size shapes ----------------------------
    beam = tt.generate_grid_tet(100, 32, 8, (0, 0, 0), (60, 20, 4))
    box = tt.generate_grid_hex(100, 32, 8, (0, 0, 0), (60, 20, 4))
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    simp_material = tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0)
    box_lam, box_mu = simp_material.lame(
        tt.models.vfrac04_density_for(box))     # per-element SIMP values
    shapes = {"tet4_apply": (beam, np.full(beam.n_cells, lam0),
                             np.full(beam.n_cells, mu0)),
              "hex8_apply": (box, box_lam, box_mu)}
    u_np = {name: np.random.default_rng(0).standard_normal(m.n_dofs)
            for name, (m, _, _) in shapes.items()}

    def inputs(name, dtype):
        m, lam, mu = shapes[name]
        return (torch.as_tensor(m.coords, dtype=dtype, device=dev),
                torch.as_tensor(m.conn, device=dev),
                torch.as_tensor(u_np[name], dtype=dtype, device=dev),
                torch.as_tensor(lam, dtype=dtype, device=dev),
                torch.as_tensor(mu, dtype=dtype, device=dev))

    errs = {}
    for name, (kern, plain) in kernel_fns.items():
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            args = inputs(name, dtype)
            out_k = kern(*args)
            torch.cuda.synchronize()
            out_p = plain(*args)
            check(out_k.shape == out_p.shape, f"{name} shape {out_k.shape}")
            check(bool(torch.isfinite(out_k).all()), f"{name} not finite")
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            errs[(name, dname)] = err
            print(f"[parity] {name} {dname} C={args[1].shape[0]} "
                  f"max_abs_err={err:.3e} max|plain|={scale:.3e} "
                  f"rel={err / scale:.3e} (tol {TOLERANCE[dname]:.0e})",
                  flush=True)
            check(err <= TOLERANCE[dname] * scale,
                  f"{name} {dname} disagrees with its plain version")
    print("[parity] errors " + json.dumps(
        {name: {"max_abs_err_fp64": errs[(name, "float64")],
                "max_abs_err_fp32": errs[(name, "float32")]}
         for name in kernel_fns}), flush=True)

    def solve(problem, config, kernel):
        """One main-path solve: counts set to 0 just before, read after."""
        ek.reset_launch_counts()
        st.reset_launch_counts()
        bo.reset_launch_counts()
        t = time.perf_counter()
        result = (tt.solve_system(problem, config) if config is not None
                  else tt.solve_system(problem))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {**ek.LAUNCHES, **st.LAUNCHES, **bo.LAUNCHES}
        for n, c in launches.items():
            main_path_launches[n] += c
        check(launches[kernel] > 0, f"{kernel} was not launched by the solve")
        check(result.method == "cg",
              f"solve took route {result.method!r}, not cg")
        check(np.all(np.isfinite(result.u)), "non-finite displacements")
        check(np.all(np.isfinite(result.von_mises)), "non-finite von Mises")
        return result, seconds, launches[kernel]

    def setup(mesh, dtype, density=None):
        p = tt.setup_problem(mesh, dtype=dtype)
        if density is None:
            tt.assemble_stiffness_matrix(p, lam0, mu0)
        else:
            tt.assemble_stiffness_matrix_simp(p, simp_material, density)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 60.0), [0.0, 0.0, -1.0])
        return p

    def oracle_energy(p):
        mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
        K = assemble_scipy(p.mesh, p.lam, p.mu, free_mask=mask)
        u = direct_solve(K, p.f * mask)
        return 0.5 * float(u @ (K @ u))

    def report(tag, r, seconds, launches, ref):
        rel = abs(r.energy - ref) / abs(ref)
        print(f"[{tag}] method={r.method} iterations={r.iterations} "
              f"converged={r.converged} "
              f"refinement_passes={r.refinement_passes} "
              f"energy={r.energy!r} rel_err={rel:.3e} "
              f"solve_s={seconds:.3f} "
              f"ms_per_iter={1e3 * r.solve_time / max(r.iterations, 1):.4f} "
              f"launches={launches} max_vm={r.max_von_mises:.6e}",
              flush=True)
        return rel

    # -- 3. bundled fixtures on the device CG route ---------------------------
    data = os.path.join(repo, "data")
    with tempfile.TemporaryDirectory() as tmp:
        for tag, fname, dtype, kernel, simp_on in (
                ("simp_hex8_fp32", "beam_vfrac_04_Raw.vtu", torch.float32,
                 "hex8_apply", True),
                ("cantilever_tet4_fp64", "beam_linear_volume_mesh.vtu",
                 torch.float64, "tet4_apply", False)):
            path = os.path.join(data, fname)
            mesh = tt.import_mesh(path)
            density = tt.extract_cell_density(path) if simp_on else None
            p = setup(mesh, dtype, density)
            ref = oracle_energy(p)
            r, secs, launches = solve(p, CG, kernel)
            rel = report(tag, r, secs, launches, ref)
            check(r.converged, f"{tag} did not converge")
            check(rel <= 1e-8, f"{tag} energy rel_err {rel:.3e} > 1e-8")
            out = tt.export_results(r, p, os.path.join(tmp, tag))
            check(os.path.getsize(out) > 0, f"{tag} export is empty")

        # -- 4. real size: 153,600 tets through .vtu ---------------------
        path = tt.write_vtu(os.path.join(tmp, "beam_scale_8.vtu"), beam)
        mesh = tt.import_mesh(path)
        check(np.array_equal(mesh.coords, beam.coords)
              and np.array_equal(mesh.conn, beam.conn),
              "scale-8 beam does not round-trip through .vtu")
        with open(os.path.join(data, "oracle_energies.json")) as fh:
            ref = json.load(fh)["tet_beam_scale_8"]
        beam_problems = {}
        for tag, dtype in (("beam8_fp64", torch.float64),
                           ("beam8_fp32", torch.float32)):
            p = setup(mesh, dtype)
            beam_problems[tag] = p
            check(p.n_dofs == 89_991, f"scale-8 beam has {p.n_dofs} dofs")
            r, secs, launches = solve(p, None, "tet4_apply")
            rel = report(tag, r, secs, launches, ref)
            if dtype == torch.float64:
                block_jacobi_iterations = r.iterations
                check(r.converged, "scale-8 fp64 solve did not converge")
                check(rel <= 1e-8, f"scale-8 fp64 rel_err {rel:.3e} > 1e-8")

    # -- 5. kernel times ----------------------------------------------------
    def time_ms(fn, reps=21, inner=10, graph=False):
        """Median per-call time (CUDA events) over ``reps`` batches of
        ``inner`` calls, after warm-up.  With ``graph`` the batch is
        captured once in a CUDA graph and replayed, so the host-side
        Python between launches is not timed: device time only."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(inner):
                    fn()
            batch = g.replay
        else:
            def batch():
                for _ in range(inner):
                    fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            batch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    records = []
    for name, (kern, plain) in kernel_fns.items():
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            args = inputs(name, dtype)
            coords, conn, u, lam, mu = args
            C, k = conn.shape
            item = coords.element_size()
            nbytes = (coords.numel() * item + conn.numel() * 4
                      + u.numel() * item + 2 * C * item + C * k * 3 * item)
            flops = FLOPS_PER_ELEMENT[name] * C
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dname]
            etype = "tet4" if k == 4 else "hex8"
            ke = element_stiffness(coords[conn.long()], lam, mu, etype, 2)
            ue = u.reshape(-1, 3)[conn.long()].reshape(C, 3 * k, 1)
            vals = {
                "ms": time_ms(lambda: kern(*args), graph=True),
                "plain_ms": time_ms(lambda: plain(*args), reps=21, inner=2),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(lambda: torch.bmm(ke, ue), graph=True),
                "max_abs_err": errs[(name, dname)],
                "eager_ms": time_ms(lambda: kern(*args)),
            }
            del ke, ue
            print(f"[time] {name} {dname} C={C} " + " ".join(
                f"{key}={val}" for key, val in vals.items()), flush=True)
            if dtype == torch.float32:
                rec.update(vals)
                rec["dtype"] = "float32"
            else:
                rec.update({f"{key}_fp64": val for key, val in vals.items()})
        records.append(rec)

    # -- 6. where one CG iteration's time goes (real-size beam) -----------
    from topopteval_tpu_torch.fem.solvers import apply_preconditioner, cg
    for tag, p in beam_problems.items():
        op = p.build_operator()
        M = tt_api._build_preconditioner(op, CG)
        b = torch.as_tensor(p.f, dtype=p.dtype, device=dev) * op.free_mask
        dm = op.dmesh
        f_e = ek.tet4_apply(dm.coords, dm.conn, b, op.lam, op.mu)
        parts = {
            "element_apply": time_ms(
                lambda: ek.tet4_apply(dm.coords, dm.conn, b, op.lam, op.mu)),
            "scatter": time_ms(lambda: op.plan.scatter_add(f_e)),
            "matvec": time_ms(lambda: op.matvec(b)),
            "precond": time_ms(lambda: apply_preconditioner(M, b)),
            "dot_fp64": time_ms(lambda: torch.dot(b.double(), b.double())),
        }
        iters = 200
        cg(op, b, M=M, tol=0.0, maxiter=10)            # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        cg(op, b, M=M, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / iters
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            cg(op, b, M=M, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
        # kernel rows only: an op row (aten::bmm) repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return e.self_device_time_total

        device_ms = sum(dev_us(e) for e in kernels) / 1e3 / iters
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
                else "not measured")
        print(f"[breakdown] {tag} cg_wall_ms_per_iter={wall_ms:.4f} "
              f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
              flush=True)
        print(f"[breakdown] {tag} top device ops per iteration (ms): "
              + ", ".join(f"{e.key[:48]}={dev_us(e) / 1e3 / iters:.4f}"
                          for e in top), flush=True)

    # -- 7. structured multigrid: stencil kernels and the full-size beam ----
    stencil_fns = {"stencil_plane": "plane", "stencil_window": "window"}
    with open(os.path.join(repo, "data", "oracle_energies.json")) as fh:
        oracles = json.load(fh)

    def stencil_args(dims, dtype, simp, seed=0):
        """(u, esc, ke, dims) on the card for a box of BEAM_BOX."""
        nx, ny, nz = dims
        rng = np.random.default_rng(seed)
        op = tt.StructuredStiffnessOperator.build(
            nx, ny, nz, (0, 0, 0), BEAM_BOX, lam0, mu0,
            escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
            dtype=dtype)
        u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype,
                            device=dev)
        return u, op.escale, op.ke, dims

    # 7a. parity at the scale-16 lattice, its coarsest smoothed level and
    # an odd box where every boundary case occurs
    stencil_errs = {}
    for dims in ((200, 64, 16), (50, 16, 4), (7, 5, 3)):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            for simp in (False, True):
                args = stencil_args(dims, dtype, simp)
                out_p = st.stencil_matvec_reference(*args)
                scale = float(out_p.abs().max())
                outs = {}
                for name, kernel in stencil_fns.items():
                    before = st.LAUNCHES[name]
                    outs[name] = st.stencil_matvec(*args, kernel=kernel)
                    torch.cuda.synchronize()
                    check(st.LAUNCHES[name] == before + 1,
                          f"{name} did not count its launch")
                    check(bool(torch.isfinite(outs[name]).all()),
                          f"{name} not finite")
                    err = float((outs[name] - out_p).abs().max())
                    if dims == (200, 64, 16) and not simp:
                        stencil_errs[(name, dname)] = err
                    print(f"[parity] {name} {dname} dims={dims} "
                          f"esc={'random' if simp else 'none'} "
                          f"max_abs_err={err:.3e} max|plain|={scale:.3e} "
                          f"rel={err / scale:.3e} "
                          f"(tol {TOLERANCE[dname]:.0e})", flush=True)
                    check(err <= TOLERANCE[dname] * scale,
                          f"{name} {dname} {dims} disagrees with its plain "
                          "version")
                gap = float((outs["stencil_plane"]
                             - outs["stencil_window"]).abs().max())
                print(f"[parity] plane vs window {dname} dims={dims} "
                      f"esc={'random' if simp else 'none'} "
                      f"max_abs_diff={gap:.3e} bit_equal={gap == 0.0}",
                      flush=True)
                check(gap <= TOLERANCE[dname] * scale,
                      f"plane and window disagree at {dims} {dname}")

    def beam_problem(scale, dtype, escale=None):
        mesh = tt.generate_grid_tet(25 * scale // 2, 4 * scale, scale,
                                    (0, 0, 0), BEAM_BOX)
        p = setup(mesh, dtype)
        if escale is not None:      # per-hex scale, x-major hex order
            e_t = np.repeat(escale.transpose(2, 1, 0).reshape(-1), 6)
            p.lam, p.mu = p.lam * e_t, p.mu * e_t
        return p

    MG = tt.SolverConfig(**MG_KW)
    mg_results = {}
    for scale in (4, 8, 16):
        p = beam_problem(scale, torch.float64)
        r, secs, launches = solve(p, MG, "stencil_plane")
        rel = report(f"mg_beam{scale}_fp64", r, secs, launches,
                     oracles[f"tet_beam_scale_{scale}"])
        print(f"[mg_beam{scale}_fp64] dofs={p.n_dofs} tets={p.mesh.n_cells} "
              f"levels={len(tt_api._get_multigrid(p)[1].levels) + 1} "
              f"build_operator_s={r.timings['build_operator']:.3f} "
              f"postprocess_s={r.timings['postprocess']:.3f}", flush=True)
        check(r.converged, f"scale-{scale} multigrid did not converge")
        check(rel <= 1e-8, f"scale-{scale} multigrid rel_err {rel:.3e}")
        mg_results[scale] = (p, r)
    check(mg_results[16][0].n_dofs == 666_315
          and mg_results[16][0].mesh.n_cells == 1_228_800,
          "scale-16 beam is not the 1,228,800-tet / 666,315-DOF box")
    print(f"[mg_beam8_fp64] iterations multigrid="
          f"{mg_results[8][1].iterations} block_jacobi="
          f"{block_jacobi_iterations} (phase 4, the same beam)", flush=True)

    # 7b. the float32 cancellation check: the converged float64 scale-4
    # solution, cast to float32, through the float32 stencil.  Tolerance
    # 1e-4: the difference form leaves the float32 rounding of K u against
    # u, which the plain version and the kernel both read at 1e-5 to 3e-5
    # here; summing raw Ke*u instead is off by more than 1e-2.
    p4, r4 = mg_results[4]
    op32 = tt.StructuredStiffnessOperator.build(
        50, 16, 4, (0, 0, 0), BEAM_BOX, lam0, mu0,
        free_mask=tt.free_mask_from_bcs(p4.n_dofs, p4.bcs),
        dtype=torch.float32)
    u32 = torch.as_tensor(r4.u, dtype=torch.float32, device=dev)
    before = st.LAUNCHES["stencil_plane"]
    e32 = float(op32.energy(u32))
    check(st.LAUNCHES["stencil_plane"] == before + 1,
          "the float32 energy did not go through stencil_plane")
    m32 = op32.free_mask
    e32_plain = 0.5 * float(torch.dot(u32.double(), (
        m32 * st.stencil_matvec_reference(m32 * u32, None, op32.ke,
                                          op32.dims)).double()))
    ref = oracles["tet_beam_scale_4"]
    rel = abs(e32 - ref) / ref
    print(f"[fp32_energy] 0.5 u^T K u through stencil_plane fp32 = {e32!r} "
          f"(plain version {e32_plain!r}, rel_err "
          f"{abs(e32_plain - ref) / ref:.3e}) oracle tet_beam_scale_4 = "
          f"{ref!r} rel_err={rel:.3e} (tol 1e-04)", flush=True)
    check(rel <= 1e-4, f"float32 stencil energy rel_err {rel:.3e} > 1e-4")

    # 7c. scale 8 through the opt-in z-blocked kernel: same solve
    os.environ["TOPOPT_STENCIL_KERNEL"] = "window"
    try:
        p = beam_problem(8, torch.float64)
        r, secs, launches = solve(p, MG, "stencil_window")
    finally:
        del os.environ["TOPOPT_STENCIL_KERNEL"]
    rel = report("mg_beam8_fp64_window", r, secs, launches,
                 oracles["tet_beam_scale_8"])
    check(r.converged and rel <= 1e-8, "scale-8 window solve failed")
    check(r.iterations == mg_results[8][1].iterations,
          "window and plane solves took different iteration counts")

    # 7d. SIMP on the hex grid: seeded per-hex scale in [0.2, 1], scale 4
    esc4 = np.random.default_rng(4).uniform(0.2, 1.0, (4, 16, 50))
    p = beam_problem(4, torch.float64, escale=esc4)
    ref = oracle_energy(p)
    r, secs, launches = solve(p, MG, "stencil_plane")
    rel = report("mg_beam4_simp_fp64", r, secs, launches, ref)
    check(tt_api._get_multigrid(p)[0].escale is not None,
          "the SIMP beam did not take the per-hex scale branch")
    check(r.converged, "scale-4 SIMP multigrid did not converge")
    check(rel <= 1e-8, f"scale-4 SIMP multigrid rel_err {rel:.3e}")

    # 7e. scale 16 in float32 at tolerance 1e-10: the refinement route
    p = beam_problem(16, torch.float32)
    r, secs, launches = solve(p, MG, "stencil_plane")
    rel = report("mg_beam16_fp32", r, secs, launches,
                 oracles["tet_beam_scale_16"])
    print(f"[mg_beam16_fp32] host fp64 residual twin: build_s="
          f"{r.timings['refine_host_build_seconds']:.3f} matvecs_s="
          f"{r.timings['refine_host_matvec_seconds']:.3f} of solve_s="
          f"{r.solve_time:.3f}", flush=True)
    if r.converged:
        check(rel <= 1e-8, f"scale-16 fp32 rel_err {rel:.3e} > 1e-8")
    else:
        print("[mg_beam16_fp32] DID NOT CONVERGE: reported, not hidden",
              flush=True)
    del p, r

    # 7f. stencil kernel times at the scale-16 shape, uniform material
    # (what the main path gives them); the per-hex-scale variant beside it
    conv_w = {}

    def two_conv(u, esc, ke, dims):
        """Library yardstick: gather conv with Ke in the weights, times
        esc, scatter conv (cuDNN, TF32 off)."""
        nx, ny, nz = dims
        w1, w2 = conv_w[u.dtype]
        u5 = u.reshape(1, nz + 1, ny + 1, nx + 1, 3).permute(0, 4, 1, 2, 3)
        f = torch.nn.functional.conv3d(u5, w1)
        if esc is not None:
            f = f * esc[None, None]
        out = torch.nn.functional.conv3d(f, w2, padding=1)
        return out.permute(0, 2, 3, 4, 1).reshape(-1)

    def conv_weights(ke, dtype):
        w1 = np.zeros((24, 3, 2, 2, 2))
        w2 = np.zeros((3, 24, 2, 2, 2))
        for j, (ozj, oyj, oxj) in enumerate(st.CORNER_OFFSETS):
            for a in range(3):
                w2[a, j * 3 + a, 1 - ozj, 1 - oyj, 1 - oxj] = 1.0
                for k, (ozk, oyk, oxk) in enumerate(st.CORNER_OFFSETS):
                    for b in range(3):
                        w1[j * 3 + a, b, ozk, oyk, oxk] = ke[j * 3 + a,
                                                             k * 3 + b]
        return (torch.as_tensor(w1, dtype=dtype, device=dev),
                torch.as_tensor(w2, dtype=dtype, device=dev))

    dims16 = (200, 64, 16)
    ke16 = tt_api._get_multigrid(mg_results[16][0])[0]._hex_ke()
    for dtype in (torch.float32, torch.float64):
        conv_w[dtype] = conv_weights(ke16, dtype)
    n_cells = dims16[0] * dims16[1] * dims16[2]
    for name, kernel in stencil_fns.items():
        rec = {"name": name, "route": "cuda", "source": STENCIL_SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for simp in (False, True):
                args = stencil_args(dims16, dtype, simp)
                u, esc = args[0], args[1]
                item = u.element_size()
                nbytes = (2 * u.numel() + (n_cells if simp else 0)) * item
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = FLOPS_PER_ELEMENT[name] * n_cells / PEAK_FLOPS[dname]
                lib = two_conv(*args)
                plain = st.stencil_matvec_reference(*args)
                lib_err = float((lib - plain).abs().max()
                                / plain.abs().max())
                check(lib_err <= 10 * TOLERANCE[dname],
                      f"two-conv yardstick is off by {lib_err:.3e} {dname}")
                vals = {
                    "ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel), graph=True),
                    "plain_ms": time_ms(
                        lambda: st.stencil_matvec_reference(*args),
                        reps=11, inner=2),
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": ("bytes" if t_bytes >= t_ops
                                 else "operations"),
                    "library_ms": time_ms(lambda: two_conv(*args), reps=11,
                                          inner=4),
                    "max_abs_err": stencil_errs[(name, dname)],
                    "eager_ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel)),
                }
                print(f"[time] {name} {dname} dims={dims16} "
                      f"esc={'random' if simp else 'none'} " + " ".join(
                          f"{key}={val}" for key, val in vals.items())
                      + f" library_rel_err={lib_err:.2e}", flush=True)
                if simp:
                    continue        # the record is the main path's shape
                if dtype == torch.float32:
                    rec.update(vals)
                    rec["dtype"] = "float32"
                else:
                    rec.update({f"{key}_fp64": val
                                for key, val in vals.items()})
        records.append(rec)

    # 7g. where one MG-PCG iteration at scale 16 spends its time
    p16 = mg_results[16][0]
    op, M = tt_api._get_multigrid(p16)
    b = torch.as_tensor(p16.f, dtype=p16.dtype, device=dev) * op.free_mask
    iters = 20
    cg(op, b, M=M, tol=0.0, maxiter=3)                # warm-up
    torch.cuda.synchronize()
    st.reset_launch_counts()
    t = time.perf_counter()
    cg(op, b, M=M, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / iters
    # the start costs what an iteration costs: one matvec, one V-cycle
    per_iter = st.LAUNCHES["stencil_plane"] / (iters + 1)
    parts = {
        "matvec": time_ms(lambda: op.matvec(b)),
        "vcycle": time_ms(lambda: M.apply(b), reps=11, inner=2),
        "dot_fp64": time_ms(lambda: torch.dot(b.double(), b.double())),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cg(op, b, M=M, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    n_launched = sum(e.count for e in kernels) / iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured")
    print(f"[breakdown] mg_beam16_fp64 cg_wall_ms_per_iter={wall_ms:.4f} "
          f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
          f"stencil_launches_per_iter={per_iter:.2f} "
          f"device_kernels_per_iter={n_launched:.1f} "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
          flush=True)
    print("[breakdown] mg_beam16_fp64 top device ops per iteration (ms): "
          + ", ".join(f"{e.key[:48]}={e.self_device_time_total / 1e3 / iters:.4f}"
                      for e in top), flush=True)

    # -- 8. block-ELL multigrid on meshes without structured_info ---------
    from topopteval_tpu_torch.fem import bell as fb

    def vtu_round_trip(mesh, tmp, name):
        """``mesh`` written to .vtu and read back: an imported mesh, with
        no ``structured_info``, so multigrid takes the block-ELL route."""
        back = tt.import_mesh(tt.write_vtu(os.path.join(tmp, name), mesh))
        check(back.structured_info is None
              and np.array_equal(back.coords, mesh.coords)
              and np.array_equal(back.conn, mesh.conn),
              f"{name} does not round-trip through .vtu")
        return back

    def bell_report(tag, p, r, secs, launches, ref, energy=None):
        """report() plus the block-ELL build record; the route must be
        the block-ELL one and both of its kernels must have launched."""
        op = tt_api._get_multigrid(p)[0]
        check(isinstance(op, fb.BellSystem),
              f"{tag} did not take the block-ELL route")
        check(bo.LAUNCHES["sell_matvec"] > 0,
              f"{tag}: sell_matvec was not launched by the solve")
        info = p._mg_build_info
        rel = report(tag, r, secs, launches, ref)
        if energy is not None:
            rel = abs(energy - ref) / abs(ref)
            print(f"[{tag}] energy 0.5*u.f={energy!r} rel_err={rel:.3e} "
                  f"(the oracle's definition)", flush=True)
        indptr = op.matrix.A.indptr
        print(f"[{tag}] dofs={p.n_dofs} cells={p.mesh.n_cells} "
              f"levels={info['n_levels']} "
              f"level_nodes={info.get('level_nodes')} "
              f"fine_blocks={info['fine_blocks']} max_blocks_per_row="
              f"{int((indptr[1:] - indptr[:-1]).max())} "
              f"sell_launches={bo.LAUNCHES['sell_matvec']} "
              f"cached={info.get('cached')} "
              f"skeleton_cached={info.get('skeleton_cached')} "
              f"build_operator_s={r.timings['build_operator']:.3f} "
              f"device_bytes={info['device_bytes']} "
              f"skeleton_phases={info.get('skeleton_phases')} "
              f"value_phases={info.get('phases')} "
              f"refine_host_matvec_s="
              f"{r.timings.get('refine_host_matvec_seconds', 0.0):.3f}",
              flush=True)
        return rel, info

    MG_SIMP = tt.SolverConfig(**{**MG_KW, "max_iterations": 5000})
    with tempfile.TemporaryDirectory() as tmp:
        # 8a. the 1,228,800-tet beam through .vtu, float32, block-ELL route
        os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
        mesh = vtu_round_trip(
            tt.generate_grid_tet(200, 64, 16, (0, 0, 0), BEAM_BOX), tmp,
            "beam_scale_16.vtu")
        check(mesh.n_cells == 1_228_800 and mesh.n_dofs == 666_315,
              "scale-16 .vtu beam is not 1,228,800 tets / 666,315 DOFs")
        p16b = setup(mesh, torch.float32)
        r, secs, launches = solve(p16b, MG, "bell_matvec")
        rel, _ = bell_report("bell_beam16_fp32", p16b, r, secs, launches,
                             oracles["tet_beam_scale_16"])
        check(r.converged, "scale-16 block-ELL fp32 did not converge")
        check(rel <= 1e-8, f"scale-16 block-ELL fp32 rel_err {rel:.3e}")
        op16, M16 = tt_api._get_multigrid(p16b)
        del mesh, r

        # 8b. kernel parity at the real shapes: the scale-16 fine operator
        # (float32 with its lo plane, the bf16 V-cycle copy, the float64
        # values), the first coarse Galerkin level, the first transfers,
        # and a random matrix with empty rows
        Np16 = op16.matrix.n_rows_p
        hb = op16.host_bsr
        A_hi, lo16 = op16.matrix.A, op16.matrix.vals_lo
        A64 = bo.BlockCSR.from_numpy(
            fb._pad_indptr(hb["indptr"], Np16), hb["indices"],
            np.asarray(hb["data"]).reshape(-1, 9), Np16, torch.float64, dev)
        A_bf = M16.levels[0].op.A
        C1 = M16.levels[1].op.A
        P0, R0 = M16.levels[0].transfer.P, M16.levels[0].transfer.R
        rng = np.random.default_rng(16)
        rows = rng.integers(0, 5000, 60000)
        rows = rows[rows % 7 != 3]              # every seventh row empty
        cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, 4999)
        rnd = bo.pack_csr(rows, cols, rng.standard_normal((rows.size, 3, 3)),
                          5000, 5000, torch.float64, dev)
        rnd_t = bo.pack_csr(rows, cols, rng.standard_normal(rows.size),
                            5000, 5000, torch.float64, dev)

        def as_type(A, dtype):
            return A.with_vals(A.vals.to(dtype))

        f32, f64 = torch.float32, torch.float64
        cases = [  # (kernel, label, matrix, lo plane, vector dtype)
            ("bell_matvec", "fine_fp32_lo", A_hi, lo16, f32),
            ("bell_matvec", "fine_fp32", A_hi, None, f32),
            ("bell_matvec", "fine_bf16", A_bf, None, f32),
            ("bell_matvec", "fine_fp64", A64, None, f64),
            ("bell_matvec", "coarse1_bf16", C1, None, f32),
            ("bell_matvec", "coarse1_fp32", as_type(C1, f32), None, f32),
            ("bell_matvec", "coarse1_fp64", as_type(C1, f64), None, f64),
            ("bell_matvec", "random_fp64", rnd, None, f64),
            ("bell_matvec", "random_fp32", as_type(rnd, f32), None, f32),
            ("bell_matvec", "random_bf16", as_type(rnd, torch.bfloat16),
             None, f32),
            ("sell_matvec", "prolong0_bf16", P0, None, f32),
            ("sell_matvec", "prolong0_fp64", as_type(P0, f64), None, f64),
            ("sell_matvec", "restrict0_bf16", R0, None, f32),
            ("sell_matvec", "restrict0_fp32", as_type(R0, f32), None, f32),
            ("sell_matvec", "restrict0_fp64", as_type(R0, f64), None, f64),
            ("sell_matvec", "random_fp64", rnd_t, None, f64),
            ("sell_matvec", "random_bf16", as_type(rnd_t, torch.bfloat16),
             None, f32),
        ]
        bell_errs = {}
        bell_inputs = {}
        for name, label, A, lo, vdt in cases:
            u = torch.as_tensor(rng.standard_normal((3, A.n_cols)),
                                dtype=vdt, device=dev)
            bell_inputs[(name, label)] = (A, lo, u)
            before = bo.LAUNCHES[name]
            if name == "bell_matvec":
                out = bo.bell_matvec(u, A, lo)
                torch.cuda.synchronize()
                ref = bo.bell_matvec_reference(u, A, lo)
            else:
                out = bo.sell_matvec(u, A)
                torch.cuda.synchronize()
                ref = bo.sell_matvec_reference(u, A)
            check(bo.LAUNCHES[name] == before + 1,
                  f"{name} did not count its launch")
            check(bool(torch.isfinite(out).all()), f"{name} {label} not finite")
            empty = A.indptr[1:] == A.indptr[:-1]
            check(bool((out[:, empty] == 0).all()),
                  f"{name} {label}: an empty row is not zero")
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            tol = TOLERANCE[str(vdt).split(".")[1]]
            bell_errs[(name, label)] = err
            print(f"[parity] {name} {label} rows={A.n_rows} nnz={A.nnz} "
                  f"empty_rows={int(empty.sum())} max_abs_err={err:.3e} "
                  f"max|plain|={scale:.3e} rel={err / scale:.3e} "
                  f"(tol {tol:.0e})", flush=True)
            check(err <= tol * scale,
                  f"{name} {label} disagrees with its plain version")

        # 8c. the lo plane moves the output: on a rigid translation the hi
        # terms cancel to float32 rounding, and split - hi must equal the
        # lo plane's own product
        u = torch.zeros((3, Np16), dtype=f32, device=dev)
        n16 = op16.n_nodes
        u[0, :n16], u[1, :n16], u[2, :n16] = 1.0, -0.5, 0.25
        split = bo.bell_matvec(u, A_hi, lo16).double()
        hi = bo.bell_matvec(u, A_hi).double()
        lo_only = bo.bell_matvec(u, A_hi.with_vals(lo16)).double()
        exact = bo.bell_matvec(u.double(), A64)
        moved = float((split - hi).abs().max())
        rel_lo = float((split - hi - lo_only).norm() / lo_only.norm())
        print(f"[lo_plane] rigid translation on the scale-16 fine operator: "
              f"max|out(hi,lo)-out(hi)|={moved:.3e} "
              f"|out(hi,lo)-out(hi)-out(lo)|/|out(lo)|={rel_lo:.3e} (tol "
              f"1e-3); distance to the float64 product: split "
              f"{float((split - exact).norm()):.3e}, hi only "
              f"{float((hi - exact).norm()):.3e}", flush=True)
        check(moved > 0.0, "the lo plane does not move the output")
        check(rel_lo <= 1e-3, f"lo plane: out(hi,lo)-out(hi) is off out(lo) "
              f"by {rel_lo:.3e}")

        # 8d. the scale-8 beam through .vtu: uniform (float64, writes the
        # disk cache), the benchmark SIMP density on the same mesh and BCs
        # (float64, skeleton from the in-process cache), then the uniform
        # problem again (loads the disk cache)
        os.environ["TOPOPT_MG_CACHE_DIR"] = os.path.join(tmp, "mg_cache")
        mesh8 = vtu_round_trip(beam, tmp, "beam_scale_8.vtu")
        p8 = setup(mesh8, torch.float64)
        r8, secs, launches = solve(p8, MG, "bell_matvec")
        rel, info = bell_report("bell_beam8_fp64", p8, r8, secs, launches,
                                oracles["tet_beam_scale_8"])
        check(r8.converged and rel <= 1e-8,
              f"scale-8 block-ELL fp64 rel_err {rel:.3e}")
        check(info["cached"] is False and info["skeleton_cached"] is False,
              "scale-8 block-ELL build was not a cold build")
        p8s = setup(mesh8, torch.float64, tt.models.bench_simp_density(
            100, 32, 8))
        r, secs, launches = solve(p8s, MG_SIMP, "bell_matvec")
        e_uf = 0.5 * float(r.u @ p8s.f)
        rel, info = bell_report("bell_simp8_fp64", p8s, r, secs, launches,
                                oracles["simp_beam_scale_8"], e_uf)
        check(info["skeleton_cached"] is True,
              "the SIMP solve did not reuse the skeleton")
        check(r.converged, "scale-8 SIMP block-ELL did not converge")
        # At 1e-8 contrast float64 fixes this energy only to about 1e-4:
        # the tip nodes sit in void (u near 1e8), so the rounding of one
        # solve leaves a relative residual near eps * |K| |u| / |f| ~ 1e-4
        # whatever the solver, and the energy moves with it.  The oracle
        # is one such solve (the JAX package's SuperLU, column order
        # COLAMD).  Here the port's matrix of the same problem is solved
        # under two column orders: how far those energies lie from the
        # oracle is the reach of float64 on this system, and the multigrid
        # energy is held to twice that reach, never looser than 1e-8 would
        # be where the direct solves agree (tests/test_torch_simp_oracle.py
        # makes the same check at scale 2 on the JAX package's matrix).
        from scipy.sparse.linalg import splu
        mask = tt.free_mask_from_bcs(p8s.n_dofs, p8s.bcs)
        K8 = assemble_scipy(p8s.mesh, p8s.lam, p8s.mu,
                            free_mask=mask).tocsc()
        f8 = p8s.f * mask
        ref = oracles["simp_beam_scale_8"]

        def rel_residual(u):
            return float(np.linalg.norm(f8 - K8 @ u) / np.linalg.norm(f8))

        reach = 0.0
        for spec in ("COLAMD", "MMD_AT_PLUS_A"):
            t = time.perf_counter()
            u_d = splu(K8, permc_spec=spec).solve(f8)
            e_d = 0.5 * float(u_d @ p8s.f)
            reach = max(reach, abs(e_d - ref) / ref)
            print(f"[bell_simp8_fp64] port host direct solve ({spec}) "
                  f"0.5*u.f={e_d!r} rel_err_vs_oracle="
                  f"{abs(e_d - ref) / ref:.3e} multigrid_vs_direct="
                  f"{abs(e_uf - e_d) / e_d:.3e} rel_residual="
                  f"{rel_residual(u_d):.3e} direct_s="
                  f"{time.perf_counter() - t:.1f}", flush=True)
        gate = max(1e-8, 2.0 * reach)
        print(f"[bell_simp8_fp64] float64 reach {reach:.3e}; multigrid "
              f"rel_err {rel:.3e}, rel_residual {rel_residual(r.u):.3e}, "
              f"gate {gate:.3e}", flush=True)
        check(rel <= gate, f"scale-8 SIMP block-ELL rel_err {rel:.3e} > "
              f"{gate:.3e} (twice the direct solves' reach)")
        del u_d, K8, f8, mask
        p8r = setup(mesh8, torch.float64)
        r, secs, launches = solve(p8r, MG, "bell_matvec")
        rel, info = bell_report("bell_beam8_fp64_reload", p8r, r, secs,
                                launches, oracles["tet_beam_scale_8"])
        check(info["cached"] is True, "scale-8 hierarchy was not reloaded")
        check(r.iterations == r8.iterations
              and abs(r.energy - r8.energy) <= 1e-12 * r8.energy,
              "the reloaded hierarchy solves differently")
        os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
        del p8, p8s, p8r, mesh8

        # 8e. the SIMP Hex8 fixture, float32, block-ELL route (hex8,
        # quad_order 2), against the host direct oracle
        path = os.path.join(data, "beam_vfrac_04_Raw.vtu")
        mesh = tt.import_mesh(path)
        p = setup(mesh, torch.float32, tt.extract_cell_density(path))
        ref = oracle_energy(p)
        r, secs, launches = solve(p, MG_SIMP, "bell_matvec")
        rel, _ = bell_report("bell_simp_hex8_fp32", p, r, secs, launches,
                             ref)
        check(r.converged and rel <= 1e-8,
              f"SIMP Hex8 block-ELL fp32 rel_err {rel:.3e}")
        del p, mesh

    # 8f. block-ELL kernel times at the scale-16 shapes
    def bell_bound(name, A, lo, u):
        """(bound_ms, bound_by): bytes of every input read once and the
        output written once, against the operations the function needs."""
        nnz = A.nnz
        nbytes = (A.indptr.numel() * 4 + nnz * 4
                  + A.vals.numel() * A.vals.element_size()
                  + (0 if lo is None else lo.numel() * lo.element_size())
                  + u.numel() * u.element_size()
                  + 3 * A.n_rows * u.element_size())
        flops = FLOPS_PER_BLOCK[name] * nnz * (1 if lo is None else 2)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[str(u.dtype).split(".")[1]]
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def library_call(name, A, u):
        """One PyTorch call computing the same function (cuSPARSE): a BSR
        (3x3 blocks) or CSR matrix times node-major vectors."""
        vals = A.vals if A.vals.dtype != torch.bfloat16 else A.vals.float()
        if name == "bell_matvec":
            S = torch.sparse_bsr_tensor(
                A.indptr, A.cols, vals.reshape(-1, 3, 3),
                size=(3 * A.n_rows, 3 * A.n_cols))
            x = u.to(vals.dtype).t().reshape(-1, 1).contiguous()
        else:
            S = torch.sparse_csr_tensor(A.indptr, A.cols, vals,
                                        size=(A.n_rows, A.n_cols))
            x = u.to(vals.dtype).t().contiguous()
        return lambda: S @ x

    timed = {"bell_matvec": ["fine_fp32_lo", "fine_bf16", "fine_fp64"],
             "sell_matvec": ["restrict0_bf16", "prolong0_bf16",
                             "restrict0_fp64", "prolong0_fp64"]}
    for name, labels in timed.items():
        kern = bo.bell_matvec if name == "bell_matvec" else \
            (lambda u, A, lo=None: bo.sell_matvec(u, A))
        plain = bo.bell_matvec_reference if name == "bell_matvec" else \
            (lambda u, A, lo=None: bo.sell_matvec_reference(u, A))
        rec = {"name": name, "route": "cuda", "source": BELL_SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for i, label in enumerate(labels):
            A, lo, u = bell_inputs[(name, label)]
            bound_ms, bound_by = bell_bound(name, A, lo, u)
            lib = library_call(name, A, u)
            lib_out = lib()
            want = (plain(u, A, lo) if lo is None or name != "bell_matvec"
                    else bo.bell_matvec_reference(u, A))
            got = (lib_out.reshape(A.n_rows, 3).t() if name == "bell_matvec"
                   else lib_out.t())
            lib_err = float((got.to(want.dtype) - want).abs().max()
                            / want.abs().max())
            vals = {
                "ms": time_ms(lambda: kern(u, A, lo), graph=True),
                "plain_ms": time_ms(lambda: plain(u, A, lo), reps=11,
                                    inner=2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_ms(lib, reps=11, inner=4),
                "max_abs_err": bell_errs[(name, label)],
                "eager_ms": time_ms(lambda: kern(u, A, lo)),
            }
            print(f"[time] {name} {label} rows={A.n_rows} nnz={A.nnz} "
                  + " ".join(f"{k}={v}" for k, v in vals.items())
                  + f" library_rel_err={lib_err:.2e} (library: one "
                  f"{'BSR' if name == 'bell_matvec' else 'CSR'} product"
                  + (", hi plane only" if lo is not None else "") + ")",
                  flush=True)
            if i == 0:
                rec.update(vals)
                rec["shape"] = label
            else:
                rec.update({f"{k}_{label}": v for k, v in vals.items()})
        records.append(rec)

    # 8g. where one MG-PCG iteration at scale 16 (float32) spends its time
    b = torch.as_tensor(op16.to_cm(p16b.f), dtype=torch.float32,
                        device=dev) * op16.free_mask
    iters = 20
    cg(op16, b, M=M16, tol=0.0, maxiter=3)                # warm-up
    torch.cuda.synchronize()
    bo.reset_launch_counts()
    t = time.perf_counter()
    cg(op16, b, M=M16, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / iters
    # the start costs what an iteration costs: one matvec, one V-cycle
    per_b4 = bo.LAUNCHES["bell_matvec"] / (iters + 1)
    per_b5 = bo.LAUNCHES["sell_matvec"] / (iters + 1)
    parts = {
        "system_matvec": time_ms(lambda: op16.matvec(b)),
        "vcycle": time_ms(lambda: M16.apply(b), reps=11, inner=2),
    }
    with torch.profiler.profile(activities=acts) as prof:
        cg(op16, b, M=M16, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    n_launched = sum(e.count for e in kernels) / iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured")
    print(f"[breakdown] bell_beam16_fp32 cg_wall_ms_per_iter={wall_ms:.4f} "
          f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
          f"bell_matvec_launches_per_iter={per_b4:.2f} (predicted 13) "
          f"sell_matvec_launches_per_iter={per_b5:.2f} (predicted 6) "
          f"device_kernels_per_iter={n_launched:.1f} "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
          flush=True)
    print("[breakdown] bell_beam16_fp32 top device ops per iteration (ms): "
          + ", ".join(f"{e.key[:48]}={e.self_device_time_total / 1e3 / iters:.4f}"
                      for e in top), flush=True)

    print(f"[device] {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
