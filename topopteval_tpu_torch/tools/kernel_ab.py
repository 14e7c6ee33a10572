"""A/B timing of redesigned kernels against another tree's build of the
same kernels, on one card, in turns: the element applies B1
``tet4_apply`` and B2 ``hex8_apply`` (and B7 ``tet10_apply``, whose
kernel shares their tile skeleton), the structured stencil apply B3
``stencil_plane``, the CSR transfer B5 ``sell_matvec`` and the
scan-window block matvec B9a ``bell_window`` (with B9b ``sell_window``,
which shares its kernel).

    python -m topopteval_tpu_torch.tools.kernel_ab --baseline DIR
        [--only tet4|hex8|tet10|stencil|csr|window]

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

B3 (``--only stencil``): the baseline's ``csrc/stencil_apply.cu`` is
bound under the interface it had before its redesign,
``stencil_plane_f{32,64}(u, esc, ke, y, nx, ny, nz, stream)``, and timed
in turns with this tree's wrapper on the 50x16x4, 100x32x8 and
200x64x16-cell boxes (the 19,200-, 153,600- and 1,228,800-tet beams),
uniform and with a per-cell scale, in float32 and float64, with the
ablations ``nocompute`` (the staged corner values go to the face buffers
with no arithmetic) and ``nostore`` of both trees, the tile variants
(``tile32x4``, ``tile32x8``, ``tile64x4`` of its 16 x 8) and the z chunk
(the runtime argument of this tree's kernel); then the stencil route's
MG-PCG iteration at scale 16 in float64 (phase 7g) with either tree's B3
in ``fem/structured.stencil_matvec``.

B5 (``--only csr``): the baseline's ``csrc/bell_apply.cu`` is bound under
``sell_matvec_f{32,32_bf16,64}(indptr, cols, w, u, out, n_rows, n_cols,
stream)`` (this tree's takes its lanes before the stream) and timed on
the block-ELL route's first restriction and prolongation at scale 16
(bf16 weights under float32 vectors, as the route stores them, and
float64), cold in L2 (each call reads its own copy of the inputs, the
copies spanning twice the 50 MB L2, as chip_smoke.py phase 10e) and warm;
the ablation ``nogather`` of both trees (each entry reads u at the row's
own number, after its column load); the lanes sweep (1, 2, 4, 8, 16);
then the block-ELL route's MG-PCG iteration at scale 16 in float32 (phase
8g) with either tree's B5 in ``fem/bell.sell_matvec``.

B9a (``--only window``): the baseline's ``csrc/ell_apply.cu`` is bound
under ``bell_window_f{32,64}(cols2, vals, wblk, u, out, S, kc, n_tiles,
n_rows, n_cols, u_cs, u_ns, o_cs, o_ns, stream)`` (this tree's takes its
warps before the stream; ``sell_window`` takes them in both) and timed
on the Galerkin route's levels 1 and 2 at scale 16 (node-major, as the
V-cycle calls them), cold, float32 and float64, beside B4 on the same
blocks; the ablations ``nogather`` and ``novalues`` (the gathered u
summed with no value loads) of both trees; the warps sweep (1, 2, 4, 8,
16); B9b on the first restriction and prolongation, bit for bit against
the baseline; then the Galerkin route's MG-PCG iteration at scale 16 in
float32 (phase 10f) with either tree's B9a and B9b in
``fem/ell.bell_matvec_window`` and ``fem/multigrid.sell_matvec_window``.
Every output is held against the plain version.

Prints one line per reading and ``AB OK`` last.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
#: the same for stencil_apply.cu (B3) and ell_apply.cu (B9b)
STENCIL_ABLATIONS: Dict[Tuple[str, str], List[Tuple[str, str]]] = {
    ("baseline", "nocompute"): [(
        """    node_apply<T>(d, e, valid, ke_s, acc);
#pragma unroll
    for (int a = 0; a < 3; ++a) y[3 * n + a] = acc[a];""",
        """    for (int a = 0; a < 3; ++a) {
        acc[a] = e[a] + e[a + 4] + ke_s[a];
        for (int i = 0; i < 27; ++i) acc[a] += d[i / 9][(i / 3) % 3][i % 3][a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) y[3 * n + a] = acc[a];""")],
    ("baseline", "nostore"): [(
        """    node_apply<T>(d, e, valid, ke_s, acc);
#pragma unroll
    for (int a = 0; a < 3; ++a) y[3 * n + a] = acc[a];""",
        """    node_apply<T>(d, e, valid, ke_s, acc);
#pragma unroll
    for (int a = 0; a < 3; ++a) if (acc[a] == T(1234567)) y[3 * n + a] = acc[a];""")],
    ("current", "nocompute"): [(
        """            cell_forces<T>(p0, p0 + RY * RX, e * vlam, e * vmu, ih,
                           fbot + cell, ftop + cell);""",
        """            for (int i = 0; i < 12; ++i) {
                fbot[i * PT + cell] = p0[i] + e;
                ftop[i * PT + cell] = p0[RY * RX + i];
            }""")],
    ("current", "nostore"): [(
        "                    y[3 * n + a] = acc + ptop[a];",
        """                    { const T v_ = acc + ptop[a];
                      if (v_ == T(1234567)) y[3 * n + a] = v_; }""")],
    # the tile sweep
    ("current", "tile32x4"): [("constexpr int CX = 16, CY = 8;",
                               "constexpr int CX = 32, CY = 4;")],
    ("current", "tile32x8"): [("constexpr int CX = 16, CY = 8;",
                               "constexpr int CX = 32, CY = 8;")],
    ("current", "tile64x4"): [("constexpr int CX = 16, CY = 8;",
                               "constexpr int CX = 64, CY = 4;")],
}
#: B5 (bell_apply.cu): ``nogather`` reads u at the row's own number (or
#: the last column) instead of the entry's column, still after the
#: column load, in both loops (this tree: the one-lane loop and the
#: batches of the kernel that B4 and B5 share; only B5 is timed from
#: it).
CSR_ABLATIONS: Dict[Tuple[str, str], List[Tuple[str, str]]] = {
    ("baseline", "nogather"): [(
        "const int c = cols[j];",
        "const int c = min(n, n_cols - 1) + (cols[j] >> 31);")],
    ("current", "nogather"): [
        ("const int c = cols[j];",
         "const int c = min(r, n_cols - 1) + (cols[j] >> 31);"),
        ("c[k] = j + k * G < end ? s_c[sc + j + k * G - jc] : -1;",
         "c[k] = j + k * G < end ? min(r, n_cols - 1) "
         "+ (s_c[sc + j + k * G - jc] >> 31) : -1;")],
}
#: B9a and B9b (ell_apply.cu): ``nogather`` as for B5, in every gather of
#: the slots that run with W > 1 warps (and, in the baseline, of B9a's
#: one-thread loop); ``novalues`` sums the gathered u with no value loads
#: (B9a).
_BASE_B9A_GATHER = """            const T* __restrict__ uc = u + c * u_ns;
            x = uc[0];
            y = uc[u_cs];
            z = uc[2 * u_cs];
        }
        const T* __restrict__ v = v_t"""
_B9A_VALUES = """        a0 += v[0] * x + v[plane] * y + v[2 * plane] * z;
        a1 += v[3 * plane] * x + v[4 * plane] * y + v[5 * plane] * z;
        a2 += v[6 * plane] * x + v[7 * plane] * y + v[8 * plane] * z;"""
_NOVALUES = """        a0 += x;
        a1 += y;
        a2 += z;"""
_W_GATHER = "const T* __restrict__ uc = u + (in ? c[k] : 0) * u_ns;"
_W_NOGATHER = ("const T* __restrict__ uc = u + (in ? (int64_t)min(n, n_cols "
               "- 1) + (c[k] >> 62) : 0) * u_ns;")
WINDOW_ABLATIONS: Dict[Tuple[str, str], List[Tuple[str, str]]] = {
    ("baseline", "nogather"): [
        (_BASE_B9A_GATHER, _BASE_B9A_GATHER.replace(
            "u + c * u_ns", "u + ((int64_t)min(n, n_cols - 1) + (c >> 62)) "
            "* u_ns")),
        (_W_GATHER, _W_NOGATHER)],
    ("baseline", "novalues"): [(_B9A_VALUES, _NOVALUES)],
    ("current", "nogather"): [(_W_GATHER, _W_NOGATHER)],
    ("current", "novalues"): [(_B9A_VALUES, _NOVALUES)],
}
#: the sources the ablations of each kernel edit
ABLATED_SOURCE = {"element": "element_apply", "stencil": "stencil_apply",
                  "csr": "bell_apply", "window": "ell_apply"}
ABLATION_SETS = {"element": ABLATIONS, "stencil": STENCIL_ABLATIONS,
                 "csr": CSR_ABLATIONS, "window": WINDOW_ABLATIONS}
#: B3's tile variants, for the sweep
STENCIL_TILES = ("tile32x4", "tile32x8", "tile64x4")
#: B3's z chunks swept at the largest box (node planes a block; 0: the
#: kernel's own choice)
STENCIL_CHUNKS = (0, 1, 2, 3, 4, 6, 9, 17)
#: B3's boxes in cells: the 19,200-, 153,600- and 1,228,800-tet beams
STENCIL_BOXES = ((50, 16, 4), (100, 32, 8), (200, 64, 16))
#: the beam whose MG-PCG iterations are timed (1,228,800 tets)
MG_SCALE = 16
#: H100 SXM L2 cache, which the cold timings of B5, B9a and B9b exceed
L2_BYTES = 50 * 2 ** 20
#: B5's lanes swept through the C entry point (B9a's warps: all of
#: ops/ell.WINDOW_WARPS)
CSR_LANES = (1, 2, 4, 8, 16)
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


def _bind_stencil(lib: ctypes.CDLL, current: bool) -> None:
    """stencil_plane under this tree's interface (the wrapper's) or the
    baseline's (u, esc, ke, y, nx, ny, nz, stream)."""
    from ..ops import stencil as st
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"stencil_plane_{sfx}")
        fn.argtypes = (getattr(st._library(), f"stencil_plane_{sfx}").argtypes
                       if current else
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def _bind_csr(lib: ctypes.CDLL, current: bool) -> None:
    """sell_matvec under this tree's interface (the wrapper's, with its
    lanes) or the baseline's (indptr, cols, w, u, out, n_rows, n_cols,
    stream)."""
    from ..ops import bell
    for sfx in ("f32", "f32_bf16", "f64"):
        fn = getattr(lib, f"sell_matvec_{sfx}")
        fn.argtypes = (getattr(bell._library(), f"sell_matvec_{sfx}").argtypes
                       if current else
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def _bind_window(lib: ctypes.CDLL, current: bool) -> None:
    """bell_window and sell_window under this tree's interface (the
    wrapper's: both take warps) or the baseline's, whose bell_window takes
    no warps."""
    from ..ops import ell
    for name in ("bell_window", "sell_window"):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            types = list(getattr(ell._library(), f"{name}_{sfx}").argtypes)
            if name == "bell_window" and not current:
                del types[-2]
            fn.argtypes = types
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


def ab_times(calls: Dict[str, object], dev,
             inner: Dict[str, int] = None) -> Dict[str, float]:
    """Median ms of each call, timed in turns: a, b, ..., then reversed;
    each name's reading is the mean of its two turns (both kept).
    ``inner`` maps a name to its batch for time_ms (default 10)."""
    names = list(calls)
    order = names + names[::-1]
    got: Dict[str, List[float]] = {n: [] for n in names}
    for n in order:
        got[n].append(time_ms(calls[n], dev, inner=(inner or {}).get(n, 10)))
    return {n: float(np.mean(v)) for n, v in got.items()} | {
        f"{n}_turns": v for n, v in got.items()}


def _err(out, ref) -> float:
    return float((out.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="checkout of the tree to compare with")
    ap.add_argument("--only", choices=("tet4", "hex8", "tet10", "stencil",
                                       "csr", "window"),
                    help="one of the kernels (tet4 and hex8 with their "
                         "solves, stencil, csr and window with their "
                         "MG-PCG iterations)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] device {smi} | torch {torch.__version__}", flush=True)

    groups = [g for g, names in (("element", ("tet4", "hex8", "tet10")),
                                 ("stencil", ("stencil",)),
                                 ("csr", ("csr",)),
                                 ("window", ("window",)))
              if args.only is None or args.only in names]

    # -- build: this tree, the baseline and the ablation variants ----------
    var_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(var_dir, exist_ok=True)
    paths, sources = {}, []
    for group in groups:
        src = ABLATED_SOURCE[group]
        sources.append(src)
        texts = {}
        for tree, path in (("baseline", os.path.join(
                args.baseline, "topopteval_tpu_torch", "csrc", f"{src}.cu")),
                ("current", os.path.join(_build.CSRC_DIR, f"{src}.cu"))):
            with open(path) as fh:
                texts[tree] = fh.read()
        paths[f"base_{src}"] = os.path.join(
            args.baseline, "topopteval_tpu_torch", "csrc", f"{src}.cu")
        prefix = "" if group == "element" else f"{group}_"
        for (tree, variant), edits in ABLATION_SETS[group].items():
            path = os.path.join(var_dir, f"{prefix}{tree}_{variant}.cu")
            with open(path, "w") as fh:
                fh.write(ablated_source(texts[tree], edits))
            paths[f"{prefix}{tree}_{variant}"] = path
    seconds = _build.build(sources, paths)
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
        if name.startswith(("stencil_", "base_stencil")):
            _bind_stencil(libs[name], current=name.startswith(
                "stencil_current_"))
        elif name.startswith(("csr_", "base_bell")):
            _bind_csr(libs[name], current=name.startswith("csr_current_"))
        elif name.startswith(("window_", "base_ell")):
            _bind_window(libs[name],
                         current=name.startswith("window_current_"))
        else:
            _bind(libs[name], current=name.startswith("current_"))

    if "element" in groups:
        kernels = (["tet4_apply", "hex8_apply", "tet10_apply"]
                   if args.only is None else [f"{args.only}_apply"])
        for name in kernels:
            element_phase(name, libs, dev)
        if args.only != "tet10":
            solve_phase(libs, dev,
                        [n for n in kernels if n != "tet10_apply"])
    if "stencil" in groups:
        stencil_phase(libs, dev)
    if "csr" in groups:
        csr_phase(libs, dev)
    if "window" in groups:
        window_phase(libs, dev)
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

    cg_cfg = tt.SolverConfig(method="cg", preconditioner="block_diagonal",
                             tolerance=1e-10, max_iterations=20000,
                             verbose=False)

    cases = []
    if "tet4_apply" in names:
        cases.append(("beam8_fp64_bj", _problem(tt.generate_grid_tet(
            100, 32, 8, (0, 0, 0), (60.0, 20.0, 4.0)), torch.float64)))
    if "hex8_apply" in names:
        path = os.path.join(DATA, "beam_vfrac_04_Raw.vtu")
        cases.append(("simp_hex8_fp32_bj", _problem(
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
        p16, op, M = _galerkin_beam()
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


# ---------------------------------------------------------------------------
# B3 and B9b
# ---------------------------------------------------------------------------


def _sfx(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def stencil_call(lib, u, esc, coef, dims, zn=None):
    """A call of ``stencil_plane`` in ``lib``: the baseline's (``zn``
    None; ``coef`` is Ke) or this tree's with z chunk ``zn`` (``coef`` is
    the cell table)."""
    fn = getattr(lib, f"stencil_plane_{_sfx(u.dtype)}")
    nx, ny, nz = dims

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        y = torch.empty_like(u)
        extra = () if zn is None else (zn,)
        _raise_on(fn(u.data_ptr(), None if esc is None else esc.data_ptr(),
                     coef.data_ptr(), y.data_ptr(), nx, ny, nz, *extra,
                     stream), "stencil_plane")
        return y
    return call


def csr_call(lib, T, u, lanes=None):
    """A call of ``sell_matvec`` (B5) in ``lib``: the baseline's (``lanes``
    None) or this tree's with ``lanes`` lanes a row."""
    from ..ops import bell
    fn = getattr(lib, f"sell_matvec_{bell._SUFFIX[(u.dtype, T.vals.dtype)]}")

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((3, T.n_rows), dtype=u.dtype, device=u.device)
        extra = () if lanes is None else (lanes,)
        _raise_on(fn(T.indptr.data_ptr(), T.cols.data_ptr(),
                     T.vals.data_ptr(), u.data_ptr(), out.data_ptr(),
                     T.n_rows, T.n_cols, *extra, stream), "sell_matvec")
        return out
    return call


def window_call(lib, name, cols2, vals, wblk, u, S, kc, n_rows,
                warps=None):
    """A node-major call of ``name`` (``bell_window`` or ``sell_window``)
    in ``lib``, with ``warps`` warps for every 32 rows (None: the
    baseline's bell_window, which takes none)."""
    fn = getattr(lib, f"{name}_{_sfx(u.dtype)}")

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((n_rows, 3), dtype=u.dtype, device=u.device)
        extra = () if warps is None else (warps,)
        _raise_on(fn(cols2.data_ptr(), vals.data_ptr(), wblk.data_ptr(),
                     u.data_ptr(), out.data_ptr(), S, kc, wblk.shape[0],
                     n_rows, u.shape[0], u.stride(1), u.stride(0),
                     out.stride(1), out.stride(0), *extra, stream), name)
        return out
    return call


def _check_against(out, ref, dtype, what) -> float:
    err = _err(out, ref)
    if not err <= TOLERANCE[dtype]:
        raise AssertionError(f"{what}: rel_err {err:.3e}")
    return err


def _beam(scale):
    import topopteval_tpu_torch as tt
    return tt.generate_grid_tet(25 * scale // 2, 4 * scale, scale,
                                (0, 0, 0), (60.0, 20.0, 4.0))


def _problem(mesh, dtype, density=None):
    """The cantilever of chip_smoke.py on ``mesh``: uniform E = 1, nu =
    0.3 (or the SIMP model on ``density``), x = 0 clamped, a unit load
    on x = 60."""
    import topopteval_tpu_torch as tt
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    p = tt.setup_problem(mesh, dtype=dtype)
    if density is None:
        tt.assemble_stiffness_matrix(p, lam0, mu0)
    else:
        tt.assemble_stiffness_matrix_simp(
            p, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0), density)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return p


def _galerkin_beam(scale=MG_SCALE):
    """(problem, operator, V-cycle) of the beam of ``scale`` from a mesh
    without ``structured_info``, through TOPOPT_MG=galerkin, float32."""
    from .. import api as tt_api
    mesh = _beam(scale)
    mesh.structured_info = None
    p = _problem(mesh, torch.float32)
    os.environ["TOPOPT_MG"] = "galerkin"
    try:
        op, M = tt_api._get_multigrid(p)
    finally:
        os.environ.pop("TOPOPT_MG", None)
    return p, op, M


def mgpcg_iteration(op, M, b, iters=20):
    """(wall ms, device ms, {kernel key: device ms}) per MG-PCG iteration
    (``cg`` with tolerance 0), the device time under ``torch.profiler``."""
    import time

    from ..fem.solvers import cg
    cg(op, b, M=M, tol=0.0, maxiter=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg(op, b, M=M, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cg(op, b, M=M, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {e.key: e.self_device_time_total / 1e3 / iters for e in rows}
    return wall, sum(per.values()), per


def stencil_phase(libs, dev):
    """B3: this tree against the baseline at STENCIL_BOXES, uniform and
    SIMP, float32 and float64, with the ablations and the tile sweep (and
    the z chunk sweep at the last box, uniform); then the stencil route's
    MG-PCG iteration on the beam of MG_SCALE (float64) with either tree's
    B3."""
    import topopteval_tpu_torch as tt
    from ..fem import structured as fst
    from ..ops import stencil as st
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    base = libs["base_stencil_apply"]
    for dims in STENCIL_BOXES:
        nx, ny, nz = dims
        cells = nx * ny * nz
        for dtype in (torch.float32, torch.float64):
            for simp in (False, True):
                rng = np.random.default_rng(7)
                op = tt.StructuredStiffnessOperator.build(
                    nx, ny, nz, (0, 0, 0), (60.0, 20.0, 4.0), lam0, mu0,
                    escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp
                    else None, dtype=dtype, device=dev)
                u = torch.as_tensor(rng.standard_normal(op.n_dofs),
                                    dtype=dtype, device=dev)
                esc = op.escale
                ref = st.stencil_matvec_reference(u, esc, op.ke, dims)
                cur = (lambda: st.stencil_matvec(    # noqa: E731
                    u, esc, op.ke, dims, table=op.table))
                calls = {"baseline": stencil_call(base, u, esc, op.ke, dims),
                         "current": cur}
                o1, o2, ob = cur(), cur(), calls["baseline"]()
                torch.cuda.synchronize()
                errs = {"baseline": _check_against(ob, ref, dtype, "B3 base"),
                        "current": _check_against(o1, ref, dtype, "B3"),
                        "repeat_identical": bool(torch.equal(o1, o2))}
                if not errs["repeat_identical"]:
                    raise AssertionError(f"B3 {dims} {dtype}: repeat")
                for (tree, variant) in STENCIL_ABLATIONS:
                    lib = libs[f"stencil_{tree}_{variant}"]
                    coef = op.table if tree == "current" else op.ke
                    name = f"{tree}_{variant}"
                    calls[name] = stencil_call(
                        lib, u, esc, coef, dims,
                        0 if tree == "current" else None)
                    if variant in STENCIL_TILES:
                        errs[variant] = _check_against(
                            calls[name](), ref, dtype, f"B3 {variant}")
                if dims == STENCIL_BOXES[-1] and not simp:
                    for zn in STENCIL_CHUNKS[1:]:
                        calls[f"current_zn{zn}"] = stencil_call(
                            st._library(), u, esc, op.table, dims, zn)
                item = u.element_size()
                b_ms, b_by = bound_ms(
                    (2 * u.numel() + (cells if simp else 0)) * item,
                    372 * cells, dtype)
                times = ab_times(calls, dev)
                chunk = st._library().stencil_plane_chunk(
                    nx, ny, nz, dtype == torch.float64)
                print(f"[ab] stencil_plane {dims} {str(dtype)[6:]} "
                      f"esc={'random' if simp else 'none'} chunk={chunk} "
                      f"bound_ms={b_ms} ({b_by}) " + json.dumps(times)
                      + f" rel_err={json.dumps(errs)} speedup="
                      f"{times['baseline'] / times['current']:.3f}",
                      flush=True)
                del op, u, ref, calls
                torch.cuda.empty_cache()

    # the stencil route's MG-PCG iteration, float64
    from .. import api as tt_api
    p16 = _problem(_beam(MG_SCALE), torch.float64)
    op, M = tt_api._get_multigrid(p16)
    b = torch.as_tensor(p16.f, dtype=torch.float64, device=dev) \
        * op.free_mask
    kernels = {"current": fst.stencil_matvec}

    def base_matvec(u, esc, ke, dims, kernel=None, *, table=None):
        return stencil_call(base, u, esc, ke, tuple(dims))()

    kernels["baseline"] = base_matvec
    per = {}
    try:
        for tree in ("baseline", "current", "current", "baseline"):
            fst.stencil_matvec = kernels[tree]
            wall, dev_ms, parts = mgpcg_iteration(op, M, b)
            b3 = sum(v for k, v in parts.items()
                     if "stencil_plane" in k)
            per.setdefault(tree, []).append(
                {"wall_ms_per_iter": wall, "device_ms_per_iter": dev_ms,
                 "b3_device_ms_per_iter": b3})
    finally:
        fst.stencil_matvec = kernels["current"]
    print(f"[ab] mgpcg_iteration stencil_beam{MG_SCALE}_fp64 "
          + json.dumps(per), flush=True)


def _ell_triplets(table):
    """(rows, cols, weights) of an ``EllTable``'s slots with a nonzero
    weight, on the host."""
    Nt = table.wblk.shape[0]
    cols = table.cols2.reshape(Nt, table.S, 128).permute(0, 2, 1) \
        .reshape(-1, table.S)[:table.n_rows].cpu().numpy()
    w = table.w2.reshape(Nt, table.S, 128).permute(0, 2, 1) \
        .reshape(-1, table.S)[:table.n_rows].double().cpu().numpy()
    live = w != 0
    rows = np.repeat(np.arange(table.n_rows), table.S).reshape(cols.shape)
    return rows[live], cols[live], w[live]


def _cold(make, tensors, out_bytes, calls=10):
    """(fn, inner, copies): ``fn`` cycles through enough copies of
    ``tensors`` that they span twice the L2 (``make(*copy)`` builds the
    call on one copy, copy 0 the originals), so no call finds its
    operands left there by the one before; ``inner``, the multiple of the
    copy count nearest above ``calls``, is the batch for time_ms."""
    import itertools
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    n = max(1, -(-2 * L2_BYTES // n_bytes))
    fns = [make(*tensors)] + [make(*(t.clone() for t in tensors))
                              for _ in range(n - 1)]
    nxt = itertools.cycle(fns).__next__
    return (lambda: nxt()()), n * -(-calls // n), n


def _bell_beam(scale=MG_SCALE):
    """(problem, operator, V-cycle) of the beam of ``scale`` from a mesh
    without ``structured_info``: the block-ELL route, float32."""
    from .. import api as tt_api
    mesh = _beam(scale)
    mesh.structured_info = None
    p = _problem(mesh, torch.float32)
    op, M = tt_api._get_multigrid(p)
    return p, op, M


def csr_phase(libs, dev):
    """B5: this tree against the baseline on the block-ELL route's first
    restriction and prolongation at MG_SCALE (bf16 weights under float32
    vectors, as the route stores them, and float64), cold and warm in L2,
    with the ``nogather`` ablation of both trees and the lanes sweep; then
    that route's MG-PCG iteration (float32) with either tree's B5 in
    ``fem/bell.sell_matvec``."""
    from ..fem import bell as fb
    from ..ops import bell as bo
    base = libs["base_bell_apply"]
    p16, op, M = _bell_beam()
    tr = M.levels[0].transfer
    rng = np.random.default_rng(12)
    for label, T0 in (("restrict0", tr.R), ("prolong0", tr.P)):
        for vals_dtype in (torch.bfloat16, torch.float64):
            vec = torch.float32 if vals_dtype == torch.bfloat16 \
                else torch.float64
            T = T0.with_vals(T0.vals.to(vals_dtype))
            u = torch.as_tensor(rng.standard_normal((3, T.n_cols)),
                                dtype=vec, device=dev)
            G = bo.sell_lanes(T.n_rows, T.nnz)
            ref = bo.sell_matvec_reference(u, T)
            o1, o2 = bo.sell_matvec(u, T), bo.sell_matvec(u, T)
            ob = csr_call(base, T, u)()
            torch.cuda.synchronize()
            errs = {"baseline": _check_against(ob, ref, vec, "B5 base"),
                    "current": _check_against(o1, ref, vec, "B5"),
                    "repeat_identical": bool(torch.equal(o1, o2)),
                    "bitwise_baseline": bool(torch.equal(o1, ob))}
            if not errs["repeat_identical"]:
                raise AssertionError(f"B5 {label} {vals_dtype}: repeat")
            for g in CSR_LANES:
                errs[f"g{g}"] = _check_against(
                    csr_call(bo._library(), T, u, g)(), ref, vec,
                    f"B5 G={g}")

            def tensors(A):
                return (A.indptr, A.cols, A.vals, u)

            def make(lib, lanes=None):
                return lambda ip, c, v, uu: csr_call(
                    lib, dataclasses.replace(T, indptr=ip, cols=c, vals=v),
                    uu, lanes)

            out_bytes = 3 * T.n_rows * u.element_size()
            cold = {"baseline": _cold(make(base), tensors(T), out_bytes),
                    "current": _cold(
                        lambda ip, c, v, uu: (lambda: bo.sell_matvec(
                            uu, dataclasses.replace(T, indptr=ip, cols=c,
                                                    vals=v))),
                        tensors(T), out_bytes)}
            for tree in ("baseline", "current"):
                cold[f"{tree}_nogather"] = _cold(
                    make(libs[f"csr_{tree}_nogather"],
                         None if tree == "baseline" else G),
                    tensors(T), out_bytes)
            for g in CSR_LANES:
                if g != G:
                    cold[f"current_g{g}"] = _cold(make(bo._library(), g),
                                                  tensors(T), out_bytes)
            calls = {n: v[0] for n, v in cold.items()}
            inner = {n: v[1] for n, v in cold.items()}
            calls["baseline_warm"] = csr_call(base, T, u)
            calls["current_warm"] = lambda: bo.sell_matvec(u, T)
            inner["baseline_warm"] = inner["current_warm"] = 10
            times = ab_times(calls, dev, inner)
            nbytes = (T.indptr.numel() * 4 + T.nnz * 4
                      + T.vals.numel() * T.vals.element_size()
                      + u.numel() * u.element_size() + out_bytes)
            b_ms, b_by = bound_ms(nbytes, 6 * T.nnz, vec)
            print(f"[ab] sell_matvec {label} "
                  f"{str(vals_dtype)[6:]}/{str(vec)[6:]} rows={T.n_rows} "
                  f"nnz={T.nnz} G={G} copies={cold['current'][2]} "
                  f"bound_ms={b_ms} ({b_by}) " + json.dumps(times)
                  + f" rel_err={json.dumps(errs)} speedup="
                  f"{times['baseline'] / times['current']:.3f} (cold; "
                  "*_warm: one copy)", flush=True)
            del cold, calls
            torch.cuda.empty_cache()

    # the block-ELL route's MG-PCG iteration at scale 16, float32
    b = torch.as_tensor(op.to_cm(p16.f), dtype=torch.float32, device=dev) \
        * op.free_mask
    kernels = {"current": fb.sell_matvec,
               "baseline": lambda u, T: csr_call(base, T, u)()}
    per = {}
    try:
        for tree in ("baseline", "current", "current", "baseline"):
            fb.sell_matvec = kernels[tree]
            wall, dev_ms, parts = mgpcg_iteration(op, M, b)
            b5 = sum(v for k, v in parts.items() if "csr_matvec" in k
                     and "Weight" in k or "sell_matvec" in k)
            per.setdefault(tree, []).append(
                {"wall_ms_per_iter": wall, "device_ms_per_iter": dev_ms,
                 "b5_device_ms_per_iter": b5})
    finally:
        fb.sell_matvec = kernels["current"]
    print(f"[ab] mgpcg_iteration bell_beam{MG_SCALE}_fp32 "
          + json.dumps(per), flush=True)


def window_phase(libs, dev):
    """B9a: this tree against the baseline on the Galerkin route's levels
    1 and 2 at MG_SCALE (node-major, as the V-cycle calls them), cold,
    float32 and float64, beside B4 on the same blocks, with the
    ``nogather`` and ``novalues`` ablations of both trees and the warps
    sweep; B9b, which shares the kernel, on the first restriction and
    prolongation, against the baseline bit for bit; then that route's
    MG-PCG iteration (float32) with either tree's B9a and B9b in
    ``fem/ell.bell_matvec_window`` and ``fem/multigrid.
    sell_matvec_window``."""
    from ..fem import ell as fe
    from ..fem import multigrid as fmg
    from ..ops import bell as bo
    from ..ops import ell
    base = libs["base_ell_apply"]
    p16, op, M = _galerkin_beam()
    rng = np.random.default_rng(11)
    levels = [(f"level{i}", M.levels[i].op) for i in (1, 2)
              if i < len(M.levels) and hasattr(M.levels[i].op, "cols2")]
    for label, L in levels:
        rows_t, cols_t, blocks_t = L.triplets()
        n = L.n_nodes
        W = ell.window_warps(L.S, n)
        for dtype in (torch.float32, torch.float64):
            vals2 = L.vals2.to(dtype)
            u = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype,
                                device=dev)
            args = (L.cols2, vals2, L.wblk, L.gbounds, u, L.S, L.kc)
            kw = {"node_major": True, "n_rows": n}
            ref = ell.bell_matvec_window_reference(*args, **kw)
            o1 = ell.bell_matvec_window(*args, **kw)
            o2 = ell.bell_matvec_window(*args, **kw)
            ob = window_call(base, "bell_window", L.cols2, vals2, L.wblk, u,
                             L.S, L.kc, n)()
            torch.cuda.synchronize()
            errs = {"baseline": _check_against(ob, ref, dtype, "B9a base"),
                    "current": _check_against(o1, ref, dtype, "B9a"),
                    "repeat_identical": bool(torch.equal(o1, o2))}
            if not errs["repeat_identical"]:
                raise AssertionError(f"B9a {label} {dtype}: repeat")
            for w in ell.WINDOW_WARPS:
                errs[f"w{w}"] = _check_against(window_call(
                    ell._library(), "bell_window", L.cols2, vals2, L.wblk, u,
                    L.S, L.kc, n, w)(), ref, dtype, f"B9a W={w}")

            def make(lib, warps=None):
                return lambda c, v, wb, uu: window_call(
                    lib, "bell_window", c, v, wb, uu, L.S, L.kc, n, warps)

            tens = (L.cols2, vals2, L.wblk, u)
            out_bytes = 3 * n * u.element_size()
            cold = {"baseline": _cold(make(base), tens, out_bytes),
                    "current": _cold(
                        lambda c, v, wb, uu: (
                            lambda: ell.bell_matvec_window(
                                c, v, wb, L.gbounds, uu, L.S, L.kc, **kw)),
                        tens, out_bytes)}
            for tree in ("baseline", "current"):
                for variant in ("nogather", "novalues"):
                    cold[f"{tree}_{variant}"] = _cold(
                        make(libs[f"window_{tree}_{variant}"],
                             None if tree == "baseline" else W),
                        tens, out_bytes)
            for w in ell.WINDOW_WARPS:
                if w != W:
                    cold[f"current_w{w}"] = _cold(make(ell._library(), w),
                                                  tens, out_bytes)
            A = bo.pack_csr(rows_t, cols_t, blocks_t, n, n, dtype, dev)
            u_cm = u.t().contiguous()
            errs["b4"] = _check_against(bo.bell_matvec(u_cm, A).t(), ref,
                                        dtype, "B4")
            cold["b4"] = _cold(
                lambda ip, c, v, uu: (lambda: bo.bell_matvec(
                    uu, dataclasses.replace(A, indptr=ip, cols=c, vals=v))),
                (A.indptr, A.cols, A.vals, u_cm), out_bytes)
            calls = {k: v[0] for k, v in cold.items()}
            inner = {k: v[1] for k, v in cold.items()}
            times = ab_times(calls, dev, inner)
            item = u.element_size()
            nnz = len(rows_t)
            b_ms, b_by = bound_ms(nnz * (4 + 9 * item) + 6 * n * item,
                                  18 * nnz, dtype)
            print(f"[ab] bell_window {label} {str(dtype)[6:]} rows={n} "
                  f"S={L.S} kc={L.kc} W={W} nnz={nnz} "
                  f"copies={cold['current'][2]} bound_ms={b_ms} ({b_by}) "
                  + json.dumps(times) + f" rel_err={json.dumps(errs)} "
                  f"speedup={times['baseline'] / times['current']:.3f} "
                  "(all cold)", flush=True)
            del cold, calls, A
            torch.cuda.empty_cache()

    # B9b: the same kernel over weights, against the baseline bit for bit
    tr = M.levels[0].transfer
    for label, T, n_cols in (("restrict0", tr.R, tr.P.n_rows),
                             ("prolong0", tr.P, tr.R.n_rows)):
        W = ell.sell_warps(T.S)
        for dtype in (torch.float32, torch.float64):
            w2 = T.w2.to(dtype)
            u = torch.as_tensor(rng.standard_normal((n_cols, 3)),
                                dtype=dtype, device=dev)
            kw = {"node_major": True, "n_rows": T.n_rows}
            ref = ell.sell_matvec_window_reference(
                T.cols2, w2, T.wblk, T.gbounds, u, T.S, T.kc, **kw)
            o1 = ell.sell_matvec_window(T.cols2, w2, T.wblk, T.gbounds, u,
                                        T.S, T.kc, **kw)
            ob = window_call(base, "sell_window", T.cols2, w2, T.wblk, u,
                             T.S, T.kc, T.n_rows, W)()
            torch.cuda.synchronize()
            errs = {"current": _check_against(o1, ref, dtype, "B9b"),
                    "bitwise_baseline": bool(torch.equal(o1, ob))}
            if not errs["bitwise_baseline"]:
                raise AssertionError(f"B9b {label} {dtype}: not the "
                                     "baseline's bits")

            def make(lib):
                return lambda c, v, wb, uu: window_call(
                    lib, "sell_window", c, v, wb, uu, T.S, T.kc, T.n_rows, W)

            tens = (T.cols2, w2, T.wblk, u)
            out_bytes = 3 * T.n_rows * u.element_size()
            cold = {"baseline": _cold(make(base), tens, out_bytes),
                    "current": _cold(make(ell._library()), tens, out_bytes)}
            for tree in ("baseline", "current"):
                cold[f"{tree}_nogather"] = _cold(
                    make(libs[f"window_{tree}_nogather"]), tens, out_bytes)
            times = ab_times({k: v[0] for k, v in cold.items()}, dev,
                             {k: v[1] for k, v in cold.items()})
            print(f"[ab] sell_window {label} {str(dtype)[6:]} rows="
                  f"{T.n_rows} S={T.S} W={W} " + json.dumps(times)
                  + f" rel_err={json.dumps(errs)} (all cold)", flush=True)
            del cold
            torch.cuda.empty_cache()

    # the Galerkin route's MG-PCG iteration at scale 16, float32
    b = torch.as_tensor(p16.f, dtype=torch.float32, device=dev) \
        * op.free_mask
    current = (fe.bell_matvec_window, fmg.sell_matvec_window)

    def base_bell(cols2, vals2, wblk, gbounds, u, S, kc, *, node_major=False,
                  n_rows=None):
        return window_call(base, "bell_window", cols2, vals2, wblk, u, S,
                           kc, n_rows)()

    def base_sell(cols2, w2, wblk, gbounds, u, S, kc, *, node_major=False,
                  n_rows=None):
        return window_call(base, "sell_window", cols2, w2, wblk, u, S, kc,
                           n_rows, ell.sell_warps(S))()

    kernels = {"current": current, "baseline": (base_bell, base_sell)}
    per = {}
    try:
        for tree in ("baseline", "current", "current", "baseline"):
            fe.bell_matvec_window, fmg.sell_matvec_window = kernels[tree]
            wall, dev_ms, parts = mgpcg_iteration(op, M, b)
            b9a = sum(v for k, v in parts.items() if "bell_window" in k
                      or ("window_kernel" in k and "Block" in k))
            per.setdefault(tree, []).append(
                {"wall_ms_per_iter": wall, "device_ms_per_iter": dev_ms,
                 "b9a_device_ms_per_iter": b9a,
                 "top": sorted(parts.items(), key=lambda kv: -kv[1])[:4]})
    finally:
        fe.bell_matvec_window, fmg.sell_matvec_window = current
    print(f"[ab] mgpcg_iteration galerkin_beam{MG_SCALE}_fp32 "
          + json.dumps(per), flush=True)


if __name__ == "__main__":
    sys.exit(main())
