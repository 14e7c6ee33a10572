"""A/B timing of the element applies, B1 ``tet4_apply`` and B2
``hex8_apply`` (and B7 ``tet10_apply``, whose kernel shares their tile
skeleton), against another tree's build of the same kernels, on one card,
in turns.

    python -m topopteval_tpu_torch.tools.kernel_ab --baseline DIR
        [--only tet4|hex8|tet10]

``DIR`` is a checkout of another commit of this repository (for example
``git archive`` of the parent, unpacked).  Its
``topopteval_tpu_torch/csrc/element_apply.cu`` is built beside this
tree's (nvcc, ``-Xptxas=-v``) and bound with ctypes under the C interface
it had before the B1/B2 redesign:

    tet4_apply_f{32,64}(coords, conn, u, lam, mu, out, C, stream)
    hex8_apply_f{32,64}(coords, conn, u, lam, mu, out, C, stream)
    tet10_apply_f{32,64}(coords, tnodes, lconn, u, lam, mu, out, C, tile,
                         max_nodes, a, b, w, stream)

This tree's kernels are called through their wrappers
(``ops/element_kernels``).  Every shape is timed baseline, this tree,
this tree, baseline (CUDA events over a replayed CUDA graph of 10
launches, median of 21, as chip_smoke.py), and both outputs are held
against the plain version; B1's output also against the baseline's, bit
for bit.  The shapes: B1 on the Tet4 fixture (8,121 tets, gmsh order) and
the generated beams of scale 8 and 16 (153,600 and 1,228,800 tets); B2 on
the SIMP Hex8 fixture (4,800 hexes) and the 25,600-hex box, both with
per-element SIMP lam, mu; B7 on the scale-8 tet10 beam and the Tet4
fixture at order 2; each in float32 and float64, with the reuse of its
tile lists (conn entries over gathered rows).

At every shape of B1 and B2 the stages are priced by variants of a
source made by fixed text edits (``ABLATIONS``), built and timed beside
it: ``nogather`` reads node rows that neighbour each other instead of the
element's (conn still read), ``nostore`` computes the forces and stores
none, ``nocompute`` gathers and stores with no arithmetic in between; and
this tree's tile is swept: its two instantiated tiles, and a variant that
instantiates one more (``tile256`` for B1, ``tile32`` for B2).

Then solves with either tree's B1 and B2 swapped into the solver
(``fem/operator._APPLY``), in turns: the scale-8 beam by fp64
block-Jacobi CG (chip_smoke.py phase 4), the SIMP Hex8 fixture in fp32
(phase 3), and the device time of an MG-PCG iteration of the Galerkin
route at scale 16 in fp32 (phase 10f), under ``torch.profiler``.

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
from ..ops import element_kernels as ek
from ._timing import bound_ms, time_ms

#: fixed text edits that make an ablation variant of an element_apply.cu
#: source: (tree, variant) -> [(old, new), ...]; every ``old`` must occur
#: exactly once.  A baseline variant edits both of its one-thread kernels.
ABLATIONS: Dict[Tuple[str, str], List[Tuple[str, str]]] = {
    ("baseline", "nogather"): [
        ("const int64_t n[4] = {nd.x, nd.y, nd.z, nd.w};",
         "const int64_t n[4] = {0 + (nd.x >> 31), 1 + (nd.y >> 31), "
         "2 + (nd.z >> 31), 3 + (nd.w >> 31)};"),
        ("const int64_t n[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, "
         "hi.w};",
         "const int64_t n[8] = {0 + (lo.x >> 31), 1 + (lo.y >> 31), "
         "2 + (lo.z >> 31), 3 + (lo.w >> 31), 4 + (hi.x >> 31), "
         "5 + (hi.y >> 31), 6 + (hi.z >> 31), 7 + (hi.w >> 31)};")],
    ("baseline", "nostore"): [
        ("""            o[3 * k + a] = vol * (sig[a][0] * g[k][0] + sig[a][1] * g[k][1] +
                                  sig[a][2] * g[k][2]);""",
         """            { const T v_ = vol * (sig[a][0] * g[k][0] + sig[a][1] * g[k][1] +
                                  sig[a][2] * g[k][2]);
              if (v_ == T(1234567)) o[3 * k + a] = v_; }"""),
        ("for (int a = 0; a < 3; ++a) o[3 * k + a] = f[k][a];",
         "for (int a = 0; a < 3; ++a) if (f[k][a] == T(1234567)) "
         "o[3 * k + a] = f[k][a];")],
    ("baseline", "nocompute"): [
        ("""            o[3 * k + a] = vol * (sig[a][0] * g[k][0] + sig[a][1] * g[k][1] +
                                  sig[a][2] * g[k][2]);""",
         "            o[3 * k + a] = x[k][a] + uu[k][a] + lam[c] + mu[c];"),
        ("for (int q = 0; q < 8; ++q) {", "for (int q = 0; q < 0; ++q) {"),
        ("            f[k][a] = T(0);",
         "            f[k][a] = x[k][a] + uu[k][a];")],
    ("current", "nogather"): [(
        "const int n = ids[j];",
        "const int n = j + (ids[j] >> 31);")],
    ("current", "nostore"): [(
        "const int nval = NF * ne, nvec = nval / VEC;",
        "const int nval = s_f[0] == T(1234567) ? NF * ne : 0, "
        "nvec = nval / VEC;")],
    ("current", "nocompute"): [(
        "        if (B::TPE > 1 || e < ne) {",
        "        if (C < 0) {")],
    # one more tile size each, for the sweep (the source's two are timed
    # through the wrapper's library)
    ("current", "tile256"): [(
        "static constexpr int K = 4, TPE = 1, TILE = 128, SMALL_TILE = 64;",
        "static constexpr int K = 4, TPE = 1, TILE = 256, SMALL_TILE = 64;")],
    ("current", "tile32"): [(
        "static constexpr int K = 8, TPE = 8, TILE = 16, SMALL_TILE = 8;",
        "static constexpr int K = 8, TPE = 8, TILE = 32, SMALL_TILE = 8;")],
}
#: the tile each sweep variant adds, by kernel
SWEEP = {"tet4_apply": ("tile256", 256), "hex8_apply": ("tile32", 32)}

#: operations per element apply that the function needs (itemised in
#: chip_smoke.py FLOPS_PER_ELEMENT)
FLOPS = {"tet4_apply": 166, "hex8_apply": 2256, "tet10_apply": 1122}

TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def ablated_source(text: str, edits: List[Tuple[str, str]]) -> str:
    """``text`` with every (old, new) edit applied; raises unless each
    ``old`` occurs exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"ablation edit target occurs "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _bind(lib: ctypes.CDLL, current: bool) -> None:
    """Declare the C signatures: this tree's (the wrapper's declarations)
    or the baseline's one-thread interface of tet4 and hex8."""
    for name in ("tet4_apply", "hex8_apply", "tet10_apply"):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            if current or name == "tet10_apply":
                fn.argtypes = getattr(ek._library(),
                                      f"{name}_{sfx}").argtypes
            else:
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def apply_call(lib, name, coords, conn, u, lam, mu, tiles=None):
    """A call of ``name`` in ``lib``: under the baseline's interface
    (``tiles`` None, tet4/hex8) or on per-tile node lists (``tiles``)."""
    dtype = coords.dtype
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    C, k = conn.shape

    def call():
        # the stream of the call, which a CUDA graph's capture replaces
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((C, k, 3), dtype=dtype, device=coords.device)
        if tiles is None:
            err = fn(coords.data_ptr(), conn.data_ptr(), u.data_ptr(),
                     lam.data_ptr(), mu.data_ptr(), out.data_ptr(), C, stream)
        else:
            rule = ek.tet10_rule() if name == "tet10_apply" else ()
            err = fn(coords.data_ptr(), tiles.nodes.data_ptr(),
                     tiles.lconn.data_ptr(), u.data_ptr(), lam.data_ptr(),
                     mu.data_ptr(), out.data_ptr(), C, tiles.tile,
                     tiles.max_nodes, *rule, stream)
        _raise_on(err, name)
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
    ap.add_argument("--only", choices=("tet4", "hex8", "tet10"),
                    help="one of the kernels (tet4 and hex8 with their "
                         "solves)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] device {smi} | torch {torch.__version__}", flush=True)

    # -- build: this tree, the baseline and the ablation variants ----------
    texts = {}
    for tree, path in (("baseline", os.path.join(
            args.baseline, "topopteval_tpu_torch", "csrc",
            "element_apply.cu")),
            ("current", os.path.join(_build.CSRC_DIR, "element_apply.cu"))):
        with open(path) as fh:
            texts[tree] = fh.read()
    var_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(var_dir, exist_ok=True)
    paths = {"base_element_apply": os.path.join(
        args.baseline, "topopteval_tpu_torch", "csrc", "element_apply.cu")}
    for (tree, variant), edits in ABLATIONS.items():
        path = os.path.join(var_dir, f"{tree}_{variant}.cu")
        with open(path, "w") as fh:
            fh.write(ablated_source(texts[tree], edits))
        paths[f"{tree}_{variant}"] = path
    seconds = _build.build(["element_apply"], paths)
    print("[ab] build " + json.dumps({k: round(v, 1)
                                      for k, v in seconds.items()}),
          flush=True)
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill")):
                print(f"[ab] ptxas {name}: {line.strip()}", flush=True)
    libs = {}
    for name, path in paths.items():
        libs[name] = _build.load(name, path)
        _bind(libs[name], current=name.startswith("current_"))

    kernels = (["tet4_apply", "hex8_apply", "tet10_apply"]
               if args.only is None else [f"{args.only}_apply"])
    for name in kernels:
        element_phase(name, libs, dev)
    if args.only != "tet10":
        solve_phase(libs, dev, [n for n in kernels if n != "tet10_apply"])
    print("AB OK")
    return 0


def shapes_of(name):
    """(label, mesh, lam [C], mu [C]) of the shapes ``name`` is timed
    at."""
    import topopteval_tpu_torch as tt
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)

    def uniform(label, mesh):
        return (label, mesh, np.full(mesh.n_cells, lam0),
                np.full(mesh.n_cells, mu0))

    def beam(s):
        return tt.generate_grid_tet(25 * s // 2, 4 * s, s, (0, 0, 0),
                                    (60.0, 20.0, 4.0))

    fixture = os.path.join(DATA, "beam_linear_volume_mesh.vtu")
    if name == "tet4_apply":
        return [uniform("fixture", tt.import_mesh(fixture)),
                uniform("beam8", beam(8)), uniform("beam16", beam(16))]
    if name == "tet10_apply":
        return [uniform("fixture_order2", tt.import_mesh(fixture)
                        .to_quadratic()),
                uniform("beam8", beam(8).to_quadratic())]
    simp = tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0)
    path = os.path.join(DATA, "beam_vfrac_04_Raw.vtu")
    box = tt.generate_grid_hex(100, 32, 8, (0, 0, 0), (60.0, 20.0, 4.0))
    return [("simp_fixture", tt.import_mesh(path),
             *simp.lame(tt.extract_cell_density(path))),
            ("box", box, *simp.lame(tt.models.vfrac04_density_for(box)))]


def element_phase(name, libs, dev):
    """One kernel at its shapes in float32 and float64: parity, bitwise
    (B1) and repeat checks, times in turns, and for B1 and B2 the
    ablations and the tile sweep."""
    plain = getattr(ek, f"{name}_reference")
    wrapper = getattr(ek, name)
    shapes = shapes_of(name)
    for label, mesh, lam, mu in shapes:
        rng = np.random.default_rng(9)
        u_np = rng.standard_normal(mesh.n_dofs)
        for dtype in (torch.float32, torch.float64):
            C = mesh.n_cells
            args5 = (torch.as_tensor(mesh.coords, dtype=dtype, device=dev),
                     torch.as_tensor(mesh.conn, device=dev),
                     torch.as_tensor(u_np, dtype=dtype, device=dev),
                     torch.as_tensor(lam, dtype=dtype, device=dev),
                     torch.as_tensor(mu, dtype=dtype, device=dev))
            tiles = ek.element_tiles(args5[1])
            ref = plain(*args5)
            base = apply_call(libs["base_element_apply"], name, *args5,
                              tiles=tiles if name == "tet10_apply" else None)
            cur = lambda: wrapper(*args5)                     # noqa: E731
            o1, o2, ob = cur(), cur(), base()
            torch.cuda.synchronize()
            errs = {"baseline": _err(ob, ref), "current": _err(o1, ref),
                    "repeat_identical": bool(torch.equal(o1, o2))}
            if name == "tet4_apply":
                errs["bitwise_baseline"] = bool(torch.equal(o1, ob))
                errs["entries_differing"] = int((o1 != ob).sum())
                errs["max_abs_diff_baseline"] = float((o1 - ob).abs().max())
            item = args5[0].element_size()
            k = args5[1].shape[1]
            nbytes = (args5[0].numel() * item + args5[1].numel() * 4
                      + args5[2].numel() * item + 2 * C * item
                      + 3 * k * C * item)
            b_ms, b_by = bound_ms(nbytes, FLOPS[name] * C, dtype)
            calls = {"baseline": base, "current": cur}
            if name in SWEEP:
                for (tree, variant) in ABLATIONS:
                    if variant.startswith("tile"):
                        continue
                    lib = libs[f"{tree}_{variant}"]
                    calls[f"{tree}_{variant}"] = apply_call(
                        lib, name, *args5,
                        tiles=tiles if tree == "current" else None)
                variant, tile = SWEEP[name]
                for t in ek.TILES[k]:
                    if t != tiles.tile:
                        calls[f"current_tile{t}"] = apply_call(
                            ek._library(), name, *args5,
                            tiles=ek.element_tiles_of(args5[1], t))
                calls[f"current_{variant}"] = apply_call(
                    libs[f"current_{variant}"], name, *args5,
                    tiles=ek.element_tiles_of(args5[1], tile))
            times = ab_times(calls, dev)
            ok = (errs["current"] <= TOLERANCE[dtype]
                  and errs["repeat_identical"])
            print(f"[ab] {name} {label} {str(dtype)[6:]} C={C} "
                  f"tile={tiles.tile} max_nodes={tiles.max_nodes} "
                  f"reuse={tiles.reuse:.3f} bound_ms={b_ms} ({b_by}) "
                  + json.dumps(times) + f" rel_err={json.dumps(errs)} "
                  f"speedup={times['baseline'] / times['current']:.3f}",
                  flush=True)
            # B7's fixture at order 2 is not gated in float32: its slivers
            # leave the float32 plain version itself ~2e-5 uncertain
            if not ok and not (name == "tet10_apply"
                               and label.startswith("fixture")
                               and dtype == torch.float32):
                raise AssertionError(f"{name} {label} {dtype}: {errs}")
            del args5, ref, o1, o2, ob, calls
            torch.cuda.empty_cache()


def solve_phase(libs, dev, names):
    """End-to-end readings, this tree's B1/B2 against the baseline's
    swapped into the same solver (``fem/operator._APPLY``), in turns."""
    import time

    import topopteval_tpu_torch as tt
    from .. import api as tt_api
    from ..fem import operator as fop
    from ..fem.solvers import cg

    base = libs["base_element_apply"]
    kernels = {"current": dict(fop._APPLY),
               "baseline": {**fop._APPLY, **{
                   et: (lambda c, n, u, lm, m, _n=f"{et}_apply":
                        apply_call(base, _n, c, n, u, lm, m)())
                   for et in ("tet4", "hex8")}}}

    def use(tree):
        fop._APPLY.update(kernels[tree])

    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    cg_cfg = tt.SolverConfig(method="cg", preconditioner="block_diagonal",
                             tolerance=1e-10, max_iterations=20000,
                             verbose=False)

    def problem(mesh, dtype, density=None):
        p = tt.setup_problem(mesh, dtype=dtype)
        if density is None:
            tt.assemble_stiffness_matrix(p, lam0, mu0)
        else:
            tt.assemble_stiffness_matrix_simp(
                p, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0),
                density)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        return p

    cases = []
    if "tet4_apply" in names:
        cases.append(("beam8_fp64_bj", problem(tt.generate_grid_tet(
            100, 32, 8, (0, 0, 0), (60.0, 20.0, 4.0)), torch.float64)))
    if "hex8_apply" in names:
        path = os.path.join(DATA, "beam_vfrac_04_Raw.vtu")
        cases.append(("simp_hex8_fp32_bj", problem(
            tt.import_mesh(path), torch.float32,
            tt.extract_cell_density(path))))
    try:
        for tag, p in cases:
            got = {}
            for tree in ("baseline", "current", "current", "baseline"):
                use(tree)
                t0 = time.perf_counter()
                r = tt.solve_system(p, cg_cfg)
                torch.cuda.synchronize()
                got.setdefault(tree, []).append(
                    {"iterations": r.iterations, "converged": r.converged,
                     "energy": r.energy, "solve_time_s": r.solve_time,
                     "ms_per_iter": 1e3 * r.solve_time
                     / max(r.iterations, 1),
                     "wall_s": time.perf_counter() - t0})
            e = {t: v[0]["energy"] for t, v in got.items()}
            print(f"[ab] solve {tag} " + json.dumps(got)
                  + f" energy_rel_diff="
                  f"{abs(e['current'] - e['baseline']) / abs(e['baseline']):.3e}",
                  flush=True)
        if "tet4_apply" not in names:
            return
        # the Galerkin route's MG-PCG iteration at scale 16 (fp32), B1 on
        # its fine level: device ms per iteration under the profiler
        os.environ["TOPOPT_MG"] = "galerkin"
        try:
            mesh = tt.generate_grid_tet(200, 64, 16, (0, 0, 0),
                                        (60.0, 20.0, 4.0))
            mesh.structured_info = None
            p16 = problem(mesh, torch.float32)
            op, M = tt_api._get_multigrid(p16)
        finally:
            os.environ.pop("TOPOPT_MG", None)
        b = torch.as_tensor(p16.f, dtype=torch.float32, device=dev) \
            * op.free_mask
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
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 \
                / iters
            b1 = sum(e.self_device_time_total for e in rows
                     if "tet4" in e.key or "Tet4" in e.key) / 1e3 / iters
            per.setdefault(tree, []).append(
                {"wall_ms_per_iter": wall, "device_ms_per_iter": dev_ms,
                 "b1_device_ms_per_iter": b1})
        print("[ab] mgpcg_iteration galerkin_beam16_fp32 " + json.dumps(per),
              flush=True)
    finally:
        use("current")


if __name__ == "__main__":
    sys.exit(main())
