"""A/B timing of the tet10 apply (B7) and the block-SpMV (B4) against
another tree's build of the same kernels, on one card, in turns.

    python -m topopteval_tpu_torch.tools.kernel_ab --baseline DIR
        [--only tet10|bell]

``DIR`` is a checkout of another commit of this repository (for example
``git archive`` of the parent, unpacked).  Its
``topopteval_tpu_torch/csrc/element_apply.cu`` and ``bell_apply.cu`` are
built beside this tree's (nvcc, ``-Xptxas=-v``) and bound with ctypes
under the C interface they had before the B7/B4 redesign:

    tet10_apply_f{32,64}(coords, conn, u, lam, mu, table, out, C, stream)
    bell_matvec_{f32,f32_bf16,f64}(indptr, cols, vals, vals_lo, u, out,
                                   n_rows, n_cols, stream)

This tree's kernels are called through their wrappers
(``ops/element_kernels.tet10_apply``, ``ops/bell.bell_matvec``).  Every
shape is timed baseline, this tree, this tree, baseline (CUDA events over
a replayed CUDA graph of 10 launches, median of 21, as chip_smoke.py),
and both outputs are held against the plain version.  The shapes are
those chip_smoke.py times: B7 on the scale-8 tet10 beam (153,600
elements) and on the Tet4 fixture at order 2, in float32 and float64; B4
on the scale-16 block-ELL fine operator (float32 with its lo plane, the
bf16 V-cycle copy, float64), its first coarse level, and the block-CSR
of the Galerkin route's level-1 operator (``TOPOPT_MG=galerkin``).

Ablations price the stages of a B7 kernel: variants of a source made by
fixed text edits (``ABLATIONS``), built and timed beside it.
``nogather`` reads every element's node rows at rows 0-9 (conn still
read), ``nostore`` computes the forces and stores none of them,
``noforce`` (baseline) drops the force loop, ``nocompute`` (this tree)
gathers and stores with no arithmetic in between.

Prints one line per reading and ``AB OK`` last.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import _build
from ..ops import bell
from ._timing import bound_ms, time_ms

#: fixed text edits that make an ablation variant of a tet10 kernel
#: source: (tree, variant) -> [(old, new), ...]; every ``old`` must occur
#: exactly once
ABLATIONS: Dict[Tuple[str, str], List[Tuple[str, str]]] = {
    ("baseline", "nogather"): [(
        "const int64_t n = conn[(c0 + e) * 10 + k];",
        "const int64_t n = k + (conn[(c0 + e) * 10 + k] >> 31);")],
    ("baseline", "nostore"): [(
        "if (live && (k & 3) == q) o[3 * k + a] = f;",
        "if (live && (k & 3) == q && f == T(1234567)) o[3 * k + a] = f;")],
    ("baseline", "noforce"): [(
        """    T* o = out + (c0 + e) * 30;
#pragma unroll 2
    for (int k = 0; k < 10; ++k) {""",
        """    T* o = out + (c0 + e) * 30;
    if (live && q == 0 && sig[0][0] + sig[1][1] + sig[2][2] + sig[0][1]
        + sig[0][2] + sig[1][2] == T(1234567)) o[0] = sig[0][0];
#pragma unroll 2
    for (int k = 0; k < 0; ++k) {""")],
    ("current", "nogather"): [(
        "const int n = ids[j];",
        "const int n = j + (ids[j] >> 31);")],
    ("current", "nostore"): [(
        "const int nval = 30 * ne, nvec = nval / VEC;",
        "const int nval = s_f[0] == T(1234567) ? 30 * ne : 0, "
        "nvec = nval / VEC;")],
    ("current", "nocompute"): [(
        "        if (tid < ne) {\n            int l[10];",
        "        if (tid < ne && C < 0) {\n            int l[10];")],
}

#: operations per tet10 apply that the function needs (itemised in
#: chip_smoke.py FLOPS_PER_ELEMENT)
FLOPS_TET10 = 1122

TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def ablated_source(text: str, edits: List[Tuple[str, str]]) -> str:
    """``text`` with every (old, new) edit applied; raises unless each
    ``old`` occurs exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"ablation edit target occurs "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _bind_baseline(lib: ctypes.CDLL, kind: str) -> None:
    if kind == "element_apply":
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"tet10_apply_{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
    else:
        for sfx in set(bell._SUFFIX.values()):
            fn = getattr(lib, f"bell_matvec_{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def tet10_call(lib, coords, conn, u, lam, mu):
    """A call of a tet10 library with the table interface, or of this
    tree's wrapper (``lib`` None)."""
    from ..ops import element_kernels as ek
    if lib is None:
        return lambda: ek.tet10_apply(coords, conn, u, lam, mu)
    dtype = coords.dtype
    table = ek.rule_table("tet10", dtype, coords.device)
    fn = getattr(lib, "tet10_apply_f32" if dtype == torch.float32
                 else "tet10_apply_f64")
    C = conn.shape[0]

    def call():
        out = torch.empty((C, 10, 3), dtype=dtype, device=coords.device)
        _raise_on(fn(coords.data_ptr(), conn.data_ptr(), u.data_ptr(),
                     lam.data_ptr(), mu.data_ptr(), table.data_ptr(),
                     out.data_ptr(), C,
                     torch.cuda.current_stream().cuda_stream), "tet10")
        return out
    return call


def bell_call(lib, u, A, lo=None):
    """A call of a bell_matvec library with the lane-free interface, or of
    this tree's wrapper (``lib`` None)."""
    if lib is None:
        return lambda: bell.bell_matvec(u, A, lo)
    fn = getattr(lib, f"bell_matvec_{bell._SUFFIX[(u.dtype, A.vals.dtype)]}")

    def call():
        out = torch.empty((3, A.n_rows), dtype=u.dtype, device=u.device)
        _raise_on(fn(A.indptr.data_ptr(), A.cols.data_ptr(),
                     A.vals.data_ptr(),
                     None if lo is None else lo.data_ptr(), u.data_ptr(),
                     out.data_ptr(), A.n_rows, A.n_cols,
                     torch.cuda.current_stream().cuda_stream), "bell")
        return out
    return call


def ab_times(calls: Dict[str, object], dev) -> Dict[str, float]:
    """Median ms of each call, timed in turns: a, b, ..., then reversed;
    each name's reading is the mean of its two turns (both kept)."""
    names = list(calls)
    order = names + names[::-1]
    got: Dict[str, List[float]] = {n: [] for n in names}
    for n in order:
        got[n].append(time_ms(calls[n], dev))
    return {n: float(np.mean(v)) for n, v in got.items()} | {
        f"{n}_turns": v for n, v in got.items()}


def _err(out, ref) -> float:
    return float((out.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="checkout of the tree to compare with")
    ap.add_argument("--only", choices=("tet10", "bell"),
                    help="one of the two kernels, its solves included")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from ..ops import element_kernels as ek

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] device {smi} | torch {torch.__version__}", flush=True)

    # -- build: this tree, the baseline and the ablation variants ----------
    base_src = {k: os.path.join(args.baseline, "topopteval_tpu_torch",
                                "csrc", f"{k}.cu")
                for k in ("element_apply", "bell_apply")}
    var_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(var_dir, exist_ok=True)
    texts = {}
    for tree, path in (("baseline", base_src["element_apply"]),
                       ("current", os.path.join(_build.CSRC_DIR,
                                                "element_apply.cu"))):
        with open(path) as fh:
            texts[tree] = fh.read()
    paths = {f"base_{k}": p for k, p in base_src.items()}
    for (tree, variant), edits in ABLATIONS.items():
        path = os.path.join(var_dir, f"{tree}_{variant}.cu")
        with open(path, "w") as fh:
            fh.write(ablated_source(texts[tree], edits))
        paths[f"{tree}_{variant}"] = path
    seconds = _build.build(["element_apply", "bell_apply"], paths)
    print("[ab] build " + json.dumps({k: round(v, 1)
                                      for k, v in seconds.items()}),
          flush=True)
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill")):
                print(f"[ab] ptxas {name}: {line.strip()}", flush=True)
    libs = {}
    for name, path in paths.items():
        lib = _build.load(name, path)
        kind = "bell_apply" if "bell" in name else "element_apply"
        if name.startswith("current_"):
            # this tree's interface, bound by the wrapper's declarations
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"tet10_apply_{sfx}")
                fn.argtypes = getattr(ek._library(),
                                      f"tet10_apply_{sfx}").argtypes
                fn.restype = ctypes.c_int
        else:
            _bind_baseline(lib, kind)
        libs[name] = lib

    def current_variant(lib, coords, conn, u, lam, mu):
        fn = getattr(lib, "tet10_apply_f32" if coords.dtype == torch.float32
                     else "tet10_apply_f64")
        C = conn.shape[0]
        t = ek.tet10_tiles(conn)

        def call():
            out = torch.empty((C, 10, 3), dtype=coords.dtype, device=dev)
            _raise_on(fn(coords.data_ptr(), t.nodes.data_ptr(),
                         t.lconn.data_ptr(), u.data_ptr(), lam.data_ptr(),
                         mu.data_ptr(), out.data_ptr(), C, t.tile,
                         t.max_nodes, *ek.tet10_rule(),
                         torch.cuda.current_stream().cuda_stream), "variant")
            return out
        return call

    # -- the readings ---------------------------------------------------------
    quad = p16 = None
    if args.only != "bell":
        quad = tet10_phase(libs, current_variant, dev)
    if args.only != "tet10":
        p16 = bell_phase(libs, dev)
    solve_phase(libs, dev, quad, p16)
    print("AB OK")
    return 0


def tet10_phase(libs, current_variant, dev):
    """B7 on the scale-8 tet10 beam (with the ablations) and on the Tet4
    fixture at order 2, fp32 and fp64; parity is gated on the beam."""
    import topopteval_tpu_torch as tt
    from ..ops import element_kernels as ek
    s = 8
    quad = tt.generate_grid_tet(25 * s // 2, 4 * s, s, (0, 0, 0),
                                (60.0, 20.0, 4.0)).to_quadratic()
    fixture = tt.import_mesh(os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data",
        "beam_linear_volume_mesh.vtu")).to_quadratic()
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    for label, mesh in ((f"beam{s}", quad), ("fixture", fixture)):
        rng = np.random.default_rng(9)
        u_np = rng.standard_normal(mesh.n_dofs)
        for dtype in (torch.float32, torch.float64):
            C = mesh.n_cells
            args7 = (torch.as_tensor(mesh.coords, dtype=dtype, device=dev),
                     torch.as_tensor(mesh.conn, device=dev),
                     torch.as_tensor(u_np, dtype=dtype, device=dev),
                     torch.full((C,), lam0, dtype=dtype, device=dev),
                     torch.full((C,), mu0, dtype=dtype, device=dev))
            ref = ek.tet10_apply_reference(*args7)
            base = tet10_call(libs["base_element_apply"], *args7)
            cur = tet10_call(None, *args7)
            o1, o2 = cur(), cur()
            torch.cuda.synchronize()
            errs = {"baseline": _err(base(), ref), "current": _err(o1, ref),
                    "repeat_identical": bool(torch.equal(o1, o2))}
            ok = (errs["current"] <= TOLERANCE[dtype]
                  and errs["baseline"] <= TOLERANCE[dtype]
                  and errs["repeat_identical"])
            item = args7[0].element_size()
            nbytes = (args7[0].numel() * item + args7[1].numel() * 4
                      + args7[2].numel() * item + 2 * C * item
                      + 30 * C * item)
            b_ms, b_by = bound_ms(nbytes, FLOPS_TET10 * C, dtype)
            calls = {"baseline": base, "current": cur}
            if label.startswith("beam"):
                for (tree, variant) in ABLATIONS:
                    lib = libs[f"{tree}_{variant}"]
                    calls[f"{tree}_{variant}"] = (
                        tet10_call(lib, *args7) if tree == "baseline"
                        else current_variant(lib, *args7))
            times = ab_times(calls, dev)
            print(f"[ab] tet10_apply {label} {str(dtype)[6:]} C={C} "
                  f"bound_ms={b_ms} ({b_by}) " + json.dumps(times)
                  + f" rel_err={json.dumps(errs)} speedup="
                  f"{times['baseline'] / times['current']:.3f}", flush=True)
            if label.startswith("beam") and not ok:
                raise AssertionError(f"tet10 {label} {dtype}: {errs}")
            del args7, ref
            torch.cuda.empty_cache()
    return quad



def bell_phase(libs, dev):
    """B4 at the scale-16 block-ELL shapes and the Galerkin route's level
    1."""
    import topopteval_tpu_torch as tt
    from .. import api as tt_api
    from ..fem import bell as fb
    from ..ops import bell as bo
    os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    s = 16
    mesh = tt.generate_grid_tet(25 * s // 2, 4 * s, s, (0, 0, 0),
                                (60.0, 20.0, 4.0))
    mesh.structured_info = None

    def setup(dtype):
        p = tt.setup_problem(mesh, dtype=dtype)
        tt.assemble_stiffness_matrix(p, lam0, mu0)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        return p

    p16 = setup(torch.float32)
    op, M = tt_api._get_multigrid(p16)
    hb = op.host_bsr
    Np = op.matrix.n_rows_p
    A_hi, lo = op.matrix.A, op.matrix.vals_lo
    A64 = bo.BlockCSR.from_numpy(
        fb._pad_indptr(hb["indptr"], Np), hb["indices"],
        np.asarray(hb["data"]).reshape(-1, 9), Np, torch.float64, dev)
    C1 = M.levels[1].op.A

    def as_type(A, dtype):
        return A.with_vals(A.vals.to(dtype))

    f32, f64 = torch.float32, torch.float64
    cases = [("fine_fp32_lo", A_hi, lo, f32),
             ("fine_bf16", M.levels[0].op.A, None, f32),
             ("fine_fp64", A64, None, f64),
             ("coarse1_bf16", C1, None, f32),
             ("coarse1_fp64", as_type(C1, f64), None, f64)]
    os.environ["TOPOPT_MG"] = "galerkin"
    try:
        _, M_g = tt_api._get_multigrid(setup(torch.float32))
    finally:
        os.environ.pop("TOPOPT_MG", None)
    L1 = M_g.levels[1].op
    n = L1.n_nodes
    rows, cols, data = L1.triplets()
    cases += [(f"galerkin_level1_{str(dt)[6:]}",
               bo.pack_csr(rows, cols, data, n, n, dt, dev), None, dt)
              for dt in (f32, f64)]
    del M_g, L1
    rng = np.random.default_rng(16)
    for label, A, lo_, vdt in cases:
        u = torch.as_tensor(rng.standard_normal((3, A.n_cols)), dtype=vdt,
                            device=dev)
        ref = bo.bell_matvec_reference(u, A, lo_)
        base = bell_call(libs["base_bell_apply"], u, A, lo_)
        cur = bell_call(None, u, A, lo_)
        o1, o2 = cur(), cur()
        torch.cuda.synchronize()
        errs = {"baseline": _err(base(), ref), "current": _err(o1, ref),
                "repeat_identical": bool(torch.equal(o1, o2))}
        nbytes = (A.indptr.numel() * 4 + A.nnz * 4
                  + A.vals.numel() * A.vals.element_size()
                  + (0 if lo_ is None else lo_.numel() * lo_.element_size())
                  + u.numel() * u.element_size()
                  + 3 * A.n_rows * u.element_size())
        b_ms, b_by = bound_ms(nbytes, 18 * A.nnz * (1 if lo_ is None else 2),
                              vdt)
        times = ab_times({"baseline": base, "current": cur}, dev)
        print(f"[ab] bell_matvec {label} rows={A.n_rows} nnz={A.nnz} "
              f"lanes={bo.bell_lanes(A.n_rows, A.nnz)} bound_ms={b_ms} "
              f"({b_by}) " + json.dumps(times)
              + f" rel_err={json.dumps(errs)} speedup="
              f"{times['baseline'] / times['current']:.3f}", flush=True)
        if not (errs["current"] <= TOLERANCE[vdt]
                and errs["repeat_identical"]):
            raise AssertionError(f"bell {label}: {errs}")
    return p16


def solve_phase(libs, dev, quad, p16):
    """End-to-end readings, this tree's kernels against the baseline's
    swapped into the same solver (``fem/operator._APPLY["tet10"]`` and
    ``fem/bell.bell_matvec``), in turns: the tet10 beam by fp64
    block-Jacobi CG (chip_smoke.py 9e), the Tet4 fixture at order 2 in
    fp64 (9d), and the scale-16 block-ELL MG-PCG in fp32 (8a), whose
    iterations are also timed alone and profiled (8g)."""
    import time

    import topopteval_tpu_torch as tt
    from .. import api as tt_api
    from ..fem import bell as fb
    from ..fem import operator as fop
    from ..fem.solvers import cg

    kernels = {"current": (fop._APPLY["tet10"], fb.bell_matvec),
               "baseline": (
                   lambda c, n, u, lm, m: tet10_call(
                       libs["base_element_apply"], c, n, u, lm, m)(),
                   lambda u, A, lo=None: bell_call(
                       libs["base_bell_apply"], u, A, lo)())}

    def use(tree):
        fop._APPLY["tet10"], fb.bell_matvec = kernels[tree]

    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    cg_cfg = tt.SolverConfig(method="cg", preconditioner="block_diagonal",
                             tolerance=1e-10, max_iterations=20000,
                             verbose=False)
    mg_cfg = tt.SolverConfig(method="cg", preconditioner="multigrid",
                             tolerance=1e-10, max_iterations=500,
                             verbose=False)

    def problem(mesh, dtype, order=1):
        p = tt.setup_problem(mesh, interpolation_order=order, dtype=dtype)
        tt.assemble_stiffness_matrix(p, lam0, mu0)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        return p

    cases = []
    if quad is not None:
        fixture = tt.import_mesh(os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "data",
            "beam_linear_volume_mesh.vtu"))
        cases += [("tet10_beam_fp64_bj", problem(quad, torch.float64),
                   cg_cfg),
                  ("tet10_fixture_fp64", problem(fixture, torch.float64, 2),
                   cg_cfg)]
    if p16 is not None:
        cases.append(("bell_beam16_fp32", p16, mg_cfg))
    try:
        for tag, p, cfg in cases:
            got = {}
            for tree in ("baseline", "current", "current", "baseline"):
                use(tree)
                t0 = time.perf_counter()
                r = tt.solve_system(p, cfg)
                torch.cuda.synchronize()
                got.setdefault(tree, []).append(
                    {"iterations": r.iterations, "converged": r.converged,
                     "energy": r.energy, "solve_time_s": r.solve_time,
                     "wall_s": time.perf_counter() - t0})
            e = {t: v[0]["energy"] for t, v in got.items()}
            print(f"[ab] solve {tag} " + json.dumps(got)
                  + f" energy_rel_diff="
                  f"{abs(e['current'] - e['baseline']) / abs(e['baseline']):.3e}",
                  flush=True)
        if p16 is not None:
            op, M = tt_api._get_multigrid(p16)
            b = torch.as_tensor(op.to_cm(p16.f), dtype=torch.float32,
                                device=dev) * op.free_mask
            iters = 20
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            per = {}
            for tree in ("baseline", "current", "current", "baseline"):
                use(tree)
                cg(op, b, M=M, tol=0.0, maxiter=3)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cg(op, b, M=M, tol=0.0, maxiter=iters)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / iters
                with torch.profiler.profile(activities=acts) as prof:
                    cg(op, b, M=M, tol=0.0, maxiter=iters)
                    torch.cuda.synchronize()
                dev_ms = sum(e.self_device_time_total
                             for e in prof.key_averages()
                             if e.device_type
                             == torch.autograd.DeviceType.CUDA) / 1e3 / iters
                per.setdefault(tree, []).append(
                    {"wall_ms_per_iter": wall, "device_ms_per_iter": dev_ms})
            print("[ab] mgpcg_iteration bell_beam16_fp32 " + json.dumps(per),
                  flush=True)
    finally:
        use("current")


if __name__ == "__main__":
    sys.exit(main())
