"""Entry points of a compile-and-run check: one SIMP-compliance lane, and
a dry run of the multi-device solves (counterpart of the JAX package's
``__graft_entry__.py``: ``entry()`` and ``dryrun_multichip(n)``).

- :func:`entry` returns ``(forward, example_args)``: one SIMP-compliance
  evaluation lane (assembly-free block-Jacobi PCG on a cantilever beam)
  and its inputs.
- :func:`dryrun_multichip` runs the three sharded legs on an ``n``-shard
  (data, elem) device grid whose shards all sit on one device the caller
  names (the card by default; several shards on one card, or on the CPU),
  each against the port's own float64 host direct solve: the halo-exchange
  CG (relative energy within 1e-4), the sharded MG-PCG through
  ``solve_system(devices=...)`` at tolerance 1e-8 (within 1e-7) and the
  data-parallel design sweep (within 1e-4).

    python -m topopteval_tpu_torch.dryrun [n_shards] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .fem.bc import DirichletBC, free_mask_from_bcs, nodes_at_plane
from .fem.operator import assemble_scipy
from .fem.solvers import cg, direct_solve
from .materials import SIMPMaterial, lame_parameters
from .mesh import Mesh
from .models.beams import generate_grid_tet


def _build_problem(nx, ny, nz):
    """The cantilever of the JAX package's dry run: (mesh, mask, f)."""
    mesh = generate_grid_tet(nx, ny, nz, (0, 0, 0), (6.0, 2.0, 1.0))
    fixed = DirichletBC.fixed(nodes_at_plane(mesh, 0, 0.0))
    mask = free_mask_from_bcs(mesh.n_dofs, [fixed])
    f = np.zeros(mesh.n_dofs)
    tip = nodes_at_plane(mesh, 0, 6.0)
    f[tip * 3 + 2] = -1.0 / tip.size
    return mesh, mask, f


def _oracle_energy(mesh: Mesh, lam_e, mu_e, mask, f) -> float:
    """float64 host direct solve of the constrained system: 0.5 u.f."""
    K = assemble_scipy(mesh, lam_e, mu_e, free_mask=mask)
    f64 = np.asarray(f, np.float64) * mask
    u = direct_solve(K, f64)
    return 0.5 * float(u @ f64)


def entry(device="cuda"):
    """(forward, example_args): ``forward(density, load)`` is the energy
    of one SIMP-compliance lane, block-Jacobi PCG at tolerance 1e-5."""
    from .parallel.sweep import SweepKernel, sweep_compliance_pairs

    mesh, mask, f = _build_problem(12, 4, 2)
    dtype = torch.float32
    kernel = SweepKernel.build(mesh, 0.3, mask, dtype=dtype, device=device)
    material = SIMPMaterial(E0=1.0, nu=0.3, Emin=1e-6, p=3.0)

    def forward(density, load):
        escale = material.youngs_modulus(density)
        energy, _, _ = sweep_compliance_pairs(kernel, escale[None],
                                              load[None], tol=1e-5,
                                              maxiter=200)
        return energy[0]

    density = torch.full((mesh.n_cells,), 0.5, dtype=dtype,
                         device=kernel.device)
    load = torch.as_tensor(f, dtype=dtype, device=kernel.device)
    return forward, (density, load)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded evaluation on an ``n_devices``-shard grid, every
    shard on ``device``; returns the three legs' relative errors and
    raises if one is off its gate."""
    import topopteval_tpu_torch as tt
    from .parallel.halo import HaloShardedOperator
    from .parallel.sharding import build_device_mesh
    from .parallel.sweep import (SweepKernel, shard_sweep_inputs,
                                 sweep_compliance)

    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dev_mesh = build_device_mesh(devices=[device] * n_devices,
                                 data_parallel=dp)
    mesh, mask, f = _build_problem(8, 4, 2)
    dtype = torch.float32
    material = SIMPMaterial(E0=1.0, nu=0.3, Emin=1e-6, p=3.0)

    # -- halo-exchange CG over the elem axis --------------------------------
    lam = np.full(mesh.n_cells, 0.576923)          # E = 1, nu = 0.3
    mu = np.full(mesh.n_cells, 0.384615)
    hop = HaloShardedOperator.build(mesh, lam, mu, dev_mesh, free_mask=mask,
                                    dtype=dtype)
    res = cg(hop, hop.to_local(f) * hop.free_mask, M=hop.block_jacobi(),
             tol=1e-6, maxiter=500)
    energy_tp = 0.5 * float(hop.from_local(res.x) @ (f * mask))
    ref = _oracle_energy(mesh, lam, mu, mask, f)
    rel_tp = abs(energy_tp - ref) / abs(ref)
    if not rel_tp <= 1e-4:
        raise RuntimeError(f"halo CG energy {energy_tp} off the direct "
                           f"solve {ref} by {rel_tp:.3e} (gate 1e-4)")

    # -- sharded MG-PCG through solve_system(devices=...) -------------------
    pmesh = _build_problem(8, 4, 2)[0]
    pmesh.structured_info = None        # the general (block-ELL) route
    prob = tt.setup_problem(pmesh, dtype=dtype, device=dev_mesh.grid[0][0])
    tt.assemble_stiffness_matrix(prob, *lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(prob, nodes_at_plane(pmesh, 0, 0.0))
    tt.apply_force(prob, nodes_at_plane(pmesh, 0, 6.0), [0.0, 0.0, -1.0])
    cfg = tt.SolverConfig(method="cg", preconditioner="multigrid",
                          tolerance=1e-8, verbose=False)
    old = os.environ.get("TOPOPT_MG_CACHE_DIR")
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["TOPOPT_MG_CACHE_DIR"] = cache_dir
        try:
            rmg = tt.solve_system(prob, cfg, devices=dev_mesh)
        finally:
            if old is None:
                os.environ.pop("TOPOPT_MG_CACHE_DIR", None)
            else:
                os.environ["TOPOPT_MG_CACHE_DIR"] = old
    if not (rmg.converged and rmg.method == "cg(multigrid,sharded)"):
        raise RuntimeError(f"sharded MG-PCG: method {rmg.method!r}, "
                           f"converged {rmg.converged}")
    mg_mask = free_mask_from_bcs(prob.n_dofs, prob.bcs)
    ref = _oracle_energy(pmesh, prob.lam, prob.mu, mg_mask, prob.f)
    rel_mg = abs(rmg.energy - ref) / abs(ref)
    # tolerance 1e-8 runs the float64-certified refinement
    if not rel_mg <= 1e-7:
        raise RuntimeError(f"sharded MG-PCG energy {rmg.energy} off the "
                           f"direct solve {ref} by {rel_mg:.3e} (gate 1e-7)")

    # -- design sweep over the data axis -------------------------------------
    B = max(dp * 2, 2)
    rng = np.random.default_rng(0)
    densities = rng.uniform(0.3, 1.0, (B, mesh.n_cells)).astype(np.float32)
    escales = material.youngs_modulus(densities.astype(np.float64))
    kernels = {}
    for d in dev_mesh.data_devices:
        if d not in kernels:
            kernels[d] = SweepKernel.build(mesh, 0.3, mask, dtype=dtype,
                                           device=d)
    escs, lds = shard_sweep_inputs(dev_mesh, escales, f[None])
    energies = np.concatenate([
        sweep_compliance(kernels[e.device], e, fl, tol=1e-6,
                         maxiter=500)[0].cpu().numpy()
        for e, fl in zip(escs, lds)])
    if energies.shape != (B, 1):
        raise RuntimeError(f"sweep energies of shape {energies.shape}")
    rel_dp = []
    for b in range(B):
        lam_b, mu_b = material.lame(densities[b].astype(np.float64))
        ref = _oracle_energy(mesh, lam_b, mu_b, mask, f)
        rel_dp.append(abs(float(energies[b, 0]) - ref) / abs(ref))
    if not max(rel_dp) <= 1e-4:
        raise RuntimeError(f"sweep energies off the direct solves by "
                           f"{max(rel_dp):.3e} (gate 1e-4)")

    out = {"grid": [dp, n_devices // dp], "device": str(device),
           "halo_cg_rel": rel_tp, "halo_cg_iterations": res.niter,
           "mg_pcg_rel": rel_mg, "mg_pcg_iterations": rmg.iterations,
           "sweep_rel_max": max(rel_dp)}
    print(f"dryrun_multichip OK: mesh=({dp}x{n_devices // dp}) on {device} "
          f"tp(energy={energy_tp:.6g}, rel={rel_tp:.1e}) "
          f"mg_pcg(energy={rmg.energy:.6g}, iters={rmg.iterations}, "
          f"rel={rel_mg:.1e}) sweep(rel_max={max(rel_dp):.1e})", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n_shards, args.device)
    fn, fargs = entry(args.device)
    print(f"entry energy: {float(fn(*fargs))}", flush=True)
    return out


if __name__ == "__main__":
    main()
