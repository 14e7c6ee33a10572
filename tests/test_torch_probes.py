"""The probe kernels of the PyTorch port against the JAX tools they
replace, on the CPU (plain versions; the kernels run on the card in
tests/test_torch_cuda.py and chip_smoke.py).

- T1, tools/tpu_ke_probe.py: the two Ke formulations
  (``_tet4_ke_kernel_cse``, ``_tet4_ke_kernel_stack``), run through the
  tool's own ``make_variant`` with Pallas in interpret mode, against
  ``tet4_ke_cse`` / ``tet4_ke_lanes`` on a 120-tet box with perturbed
  nodes and random materials, float64, rtol 1e-12 (same arithmetic).
- T2, tools/tpu_bell_ablate.py: the five modes of ``make_kernel`` (nested
  in the tool's ``main``: taken out with ``ast``, the tool untouched) in
  interpret mode against ``bell_ablate`` at scale 2 (702 nodes, S 16, kc 3,
  Nt 6) in float32, rtol 1e-6 (sums in another order), with the packed
  window and a window cut by hand to kc = 1.
- Both probes' argument parsing and a small run of each on the CPU.
"""

import ast
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
from topopteval_tpu.ops.pallas_bsr import (GROUP, LANES, bell_matvec_pallas,
                                           pack_ell_rows)
from topopteval_tpu.ops.pallas_kernels import tet4_element_stiffness_pallas
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.ops import ell as el
from topopteval_tpu_torch.ops import ke_kernels as kk
from topopteval_tpu_torch.tools import ell_ablate, ke_probe

tt.set_verbosity(False)
torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


def _rel(out, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    return np.abs(np.asarray(out) - ref).max() / (scale if scale else 1.0)


# ---------------------------------------------------------------------------
# T1: the Ke formulations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ke_tool():
    spec = importlib.util.spec_from_file_location(
        "tpu_ke_probe", os.path.join(TOOLS, "tpu_ke_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def box120():
    """A 120-tet box with perturbed nodes, random lam and mu (float64)."""
    mesh = tt.generate_grid_tet(5, 2, 2, (0, 0, 0), (5.0, 2.0, 2.0))
    rng = np.random.default_rng(120)
    coords = mesh.coords + rng.uniform(-0.2, 0.2, mesh.coords.shape)
    C = mesh.n_cells
    return (coords, mesh.conn, rng.uniform(0.5, 2.0, C),
            rng.uniform(0.5, 2.0, C))


@pytest.fixture(scope="module")
def tool_ke(ke_tool, box120):
    """Both variants' output [144, C] from the tool's own ``make_variant``
    (block 128), its ``pallas_call`` in interpret mode."""
    coords, conn, lam, mu = box120
    C = conn.shape[0]
    pad = ((0, 0), (0, 128 * -(-C // 128) - C))
    args = (jnp.asarray(np.pad(coords[conn].reshape(C, 12).T, pad)),
            jnp.asarray(np.pad(lam[None], pad)),
            jnp.asarray(np.pad(mu[None], pad)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ke_tool.pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True))
        return {name: np.asarray(ke_tool.make_variant(kernel, 128)(*args))
                [:, :C]
                for name, kernel in (("cse", ke_tool._tet4_ke_kernel_cse),
                                     ("lanes",
                                      ke_tool._tet4_ke_kernel_stack))}


@pytest.mark.parametrize("variant", ["cse", "lanes"])
@pytest.mark.parametrize("block", kk.LANE_BLOCKS)
def test_t1_variants_match_the_jax_tool(tool_ke, box120, variant, block):
    coords, conn, lam, mu = box120
    C = conn.shape[0]
    ct, Cp = kk.element_coords_lanes(torch.as_tensor(coords),
                                     torch.as_tensor(conn), block)
    lam2 = kk.pad_lanes(torch.as_tensor(lam), Cp)
    mu2 = kk.pad_lanes(torch.as_tensor(mu), Cp)
    # the tool's padding (tpu_ke_probe.py:116-120)
    np.testing.assert_array_equal(
        ct.numpy(), np.pad(coords[conn].reshape(C, 12).T,
                           ((0, 0), (0, Cp - C))))
    ref = tool_ke[variant]
    fn = kk.tet4_ke_cse if variant == "cse" else kk.tet4_ke_lanes
    out = fn(ct, lam2, mu2, block)
    assert out.shape == (144, Cp)
    assert _rel(out[:, :C].numpy(), ref) <= 1e-12
    assert not out[:, C:].any()                 # padded lanes are zero
    plain = (kk.tet4_ke_cse_reference if variant == "cse"
             else kk.tet4_ke_lanes_reference)(ct, lam2, mu2)
    assert torch.equal(plain, out)


def test_t1_equals_b6_in_the_lane_layout(box120):
    """Both variants compute B6's function: the JAX package's production
    kernel with ``transpose_out=False`` and the port's ``tet4_ke``."""
    coords, conn, lam, mu = box120
    C = conn.shape[0]
    ct, Cp = kk.element_coords_lanes(torch.as_tensor(coords),
                                     torch.as_tensor(conn), 128)
    out = kk.tet4_ke_cse(ct, kk.pad_lanes(torch.as_tensor(lam), Cp),
                         kk.pad_lanes(torch.as_tensor(mu), Cp), 128)
    b6 = np.asarray(tet4_element_stiffness_pallas(
        jnp.asarray(coords[conn]), jnp.asarray(lam), jnp.asarray(mu),
        transpose_out=False, interpret=True))
    assert _rel(out[:, :C].numpy(), b6) <= 1e-12
    port_b6 = kk.tet4_ke(torch.as_tensor(coords), torch.as_tensor(conn),
                         torch.as_tensor(lam), torch.as_tensor(mu))
    assert _rel(out[:, :C].numpy(), port_b6.reshape(C, 144).t().numpy()) \
        <= 1e-12


def test_t1_wrapper_checks():
    ct = torch.zeros(12, 256, dtype=torch.float64)
    row = torch.zeros(1, 256, dtype=torch.float64)
    with pytest.raises(ValueError, match="block"):
        kk.tet4_ke_cse(ct, row, row, 64)
    with pytest.raises(ValueError, match="multiple"):
        kk.tet4_ke_lanes(ct[:, :200], row[:, :200], row[:, :200], 128)
    with pytest.raises(ValueError, match="lam2"):
        kk.tet4_ke_cse(ct, row.float(), row, 128)
    with pytest.raises(TypeError):
        kk.tet4_ke_cse(ct.half(), row.half(), row.half(), 128)


# ---------------------------------------------------------------------------
# T2: the block-ELL ablation modes
# ---------------------------------------------------------------------------


def _tool_make_kernel():
    """``make_kernel`` of tools/tpu_bell_ablate.py, taken out of ``main``
    with ``ast``; it reads S and kc from the namespace it runs in."""
    with open(os.path.join(TOOLS, "tpu_bell_ablate.py")) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in main.body
                if isinstance(n, ast.FunctionDef) and n.name == "make_kernel")
    return compile(ast.Module(body=[node], type_ignores=[]),
                   "tpu_bell_ablate.py", "exec")


def _tool_run(code, mode, pk, u, kc):
    """One launch of the tool's kernel in interpret mode: the grid spec of
    the tool's ``run`` without its fori_loop chaining."""
    S, Np = pk["S"], pk["n_rows_p"]
    Nt = Np // LANES
    ns = {"jnp": jnp, "pl": pl, "S": S, "kc": kc, "GROUP": GROUP,
          "LANES": LANES}
    exec(code, ns)
    gb = jnp.asarray(pk["gbounds"])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(Nt,),
        in_specs=[
            pl.BlockSpec((1, 1, gb.shape[-1]), lambda i, w: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, S, LANES), lambda i, w: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 9 * S, LANES), lambda i, w: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((3, Np), lambda i, w: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((3, LANES), lambda i, w: (0, i),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((3 * S, LANES), jnp.float32)],
    )
    call = pl.pallas_call(ns["make_kernel"](mode), grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((3, Np),
                                                         jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(pk["wblk"]), gb,
                           jnp.asarray(pk["cols2"]).reshape(Nt, S, LANES),
                           jnp.asarray(pk["vals2"]).reshape(Nt, 9 * S, LANES),
                           jnp.asarray(u)))


@pytest.fixture(scope="module")
def scale2_pack():
    """The tool's scale-2 pack (JAX package triplets, RCM, float32) and
    its input vector; the port's pack of the same beam must equal it."""
    mesh = jax_grid_tet(25, 8, 2, (0, 0, 0), (60, 20, 4))
    lam, mu = tt.lame_parameters(1.0, 0.3)
    C = mesh.n_cells
    r3, c3, b3 = jax_bell.assemble_bsr_triplets(mesh, np.full(C, lam),
                                                np.full(C, mu))
    perm = jax_bell.rcm_order(r3, c3, mesh.n_nodes)
    r3, c3, b3 = jax_bell._permute_triplets(r3, c3, b3, perm)
    pk = pack_ell_rows(r3, c3, b3.astype(np.float32), mesh.n_nodes,
                       mesh.n_nodes)
    assert (pk["S"], pk["kc"], pk["n_rows_p"]) == (16, 3, 768)
    u = np.zeros((3, pk["n_rows_p"]), np.float32)
    u[:, :mesh.n_nodes] = np.random.default_rng(0).standard_normal(
        (3, mesh.n_nodes))
    return pk, u, mesh.n_nodes


def test_t2_port_pack_equals_the_tool_pack(scale2_pack):
    pk, _, _ = scale2_pack
    mine, nnz, n = ell_ablate.beam_pack(2)
    assert n == 702 and nnz == 7968
    for key in ("cols2", "wblk", "gbounds", "S", "kc", "n_rows_p"):
        np.testing.assert_array_equal(mine[key], pk[key])
    # float64 sums of the element blocks in another order: entries that
    # cancel to zero may differ at rounding level
    assert _rel(mine["vals2"].astype(np.float32), pk["vals2"]) <= 1e-6


def _port(mode, pk, u, kc):
    return el.bell_ablate(
        mode, torch.as_tensor(pk["cols2"]), torch.as_tensor(pk["vals2"]),
        torch.as_tensor(pk["wblk"]), torch.as_tensor(pk["gbounds"]),
        torch.as_tensor(u), pk["S"], kc).numpy()


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("mode", el.ABLATE_MODES)
def test_t2_modes_match_the_jax_tool(scale2_pack, mode, cut):
    pk, u, _ = scale2_pack
    kc = 1 if cut else pk["kc"]
    ref = _tool_run(_tool_make_kernel(), mode, pk, u, kc)
    out = _port(mode, pk, u, kc)
    assert out.shape == ref.shape == (3, pk["n_rows_p"])
    if mode == "empty":
        assert not ref.any() and not out.any()
    else:
        assert np.abs(ref).max() > 0
        assert _rel(out, ref) <= 1e-6
    plain = el.bell_ablate_reference(
        mode, torch.as_tensor(pk["cols2"]), torch.as_tensor(pk["vals2"]),
        torch.as_tensor(pk["wblk"]), torch.as_tensor(pk["gbounds"]),
        torch.as_tensor(u), pk["S"], kc).numpy()
    np.testing.assert_array_equal(plain, out)


def test_t2_full_is_b9a(scale2_pack):
    """``full`` and ``noskip`` are B9a's matvec, in both packages."""
    pk, u, _ = scale2_pack
    b9a = np.asarray(bell_matvec_pallas(
        jnp.asarray(pk["cols2"]), jnp.asarray(pk["vals2"]),
        jnp.asarray(pk["wblk"]), jnp.asarray(pk["gbounds"]), jnp.asarray(u),
        pk["S"], pk["kc"], interpret=True))
    port_b9a = el.bell_matvec_window(
        *(torch.as_tensor(pk[k]) for k in ("cols2", "vals2", "wblk",
                                           "gbounds")),
        torch.as_tensor(u), pk["S"], pk["kc"]).numpy()
    for mode in ("full", "noskip"):
        out = _port(mode, pk, u, pk["kc"])
        assert _rel(out, b9a) <= 1e-6
        np.testing.assert_array_equal(out, port_b9a)
    assert not _port("empty", pk, u, pk["kc"]).any()


def test_t2_wrapper_checks(scale2_pack):
    pk, u, _ = scale2_pack
    args = [torch.as_tensor(pk[k]) for k in ("cols2", "vals2", "wblk",
                                             "gbounds")]
    with pytest.raises(ValueError, match="mode"):
        el.bell_ablate("fast", *args, torch.as_tensor(u), pk["S"], 3)
    with pytest.raises(ValueError, match="unit node stride"):
        el.bell_ablate("full", *args,
                       torch.as_tensor(u).t().contiguous().t(), pk["S"], 3)
    with pytest.raises(TypeError):
        el.bell_ablate("full", *args, torch.as_tensor(u).double(), pk["S"],
                       3)


# ---------------------------------------------------------------------------
# The probes as programs
# ---------------------------------------------------------------------------


def test_probe_arguments():
    a = ke_probe.parse_args([])
    assert (a.scale, a.device, a.dtype, a.reps) == (16, "cuda", "float32",
                                                    21)
    a = ke_probe.parse_args(["4", "--device", "cpu", "--dtype", "float64"])
    assert (a.scale, a.device, a.dtype) == (4, "cpu", "float64")
    b = ell_ablate.parse_args([])
    assert (b.scale, b.device, b.dtype, b.reps) == (8, "cuda", "float32",
                                                    200)
    b = ell_ablate.parse_args(["2", "--reps", "3"])
    assert (b.scale, b.reps) == (2, 3)
    for parse, argv in ((ke_probe.parse_args, ["3"]),
                        (ke_probe.parse_args, ["--dtype", "bfloat16"]),
                        (ell_ablate.parse_args, ["2", "--reps", "0"])):
        with pytest.raises(SystemExit):
            parse(argv)


def test_probes_run_on_the_cpu(capsys):
    r = ke_probe.main(["2", "--device", "cpu", "--reps", "1",
                       "--dtype", "float64"])
    assert r["C"] == 2400
    names = [(row["name"], row["block"]) for row in r["rows"]]
    assert names == [("production", 128)] + [
        (v, b) for v in ("cse", "lanes") for b in kk.LANE_BLOCKS]
    assert max(row["max_rel_err"] for row in r["rows"]) <= 1e-12
    a = ell_ablate.main(["2", "--device", "cpu", "--reps", "1"])
    assert set(a["modes"]) == set(el.ABLATE_MODES)
    assert a["modes"]["full"]["sum"] == a["modes"]["noskip"]["sum"]
    assert a["modes"]["empty"]["sum"] == 0.0
    out = capsys.readouterr().out.strip().splitlines()
    assert "KE PROBE OK" in out and out[-1] == "ABLATE OK"
