"""The sharded paths across real cards, one shard a card: a probe for a
machine with two or more CUDA cards.

    python -m topopteval_tpu_torch.tools.multicard [--cards N]
    python -m topopteval_tpu_torch.tools.multicard --device cpu --small

(``--device cpu --small`` rehearses it with two shards on the CPU at a
tenth of the sizes.)

1. The halo operator on the scale-8 beam (153,600 tets), float64, one
   shard a card, against one card's operator (1e-12), with its
   ``tet4_apply`` launches a matvec and the wall ms of a matvec over every
   card and on one.
2. ``solve_system(devices=N)``: the sharded MG-PCG in float64 at 1e-8 on
   the scale-8 beam without its structured info (the block-ELL
   hierarchy), against one card's block-ELL MG-PCG (run twice: the first
   call pays the first use of the card): equal counts, and both energies
   within 1e-8 of ``tet_beam_scale_8`` in data/oracle_energies.json.
3. ``evaluate_design_batch`` at BASELINE config 5 (the 80x32x8 grid of
   tets over (6, 2, 1), 64 SIMP densities x 4 tip loads, float32, tol
   1e-6): one card, the pairs route (the default); one card, one card's
   share of the batch; every card (``devices=``), the pairs route; every card, the einsum route
   (``lane_chunk=64``): seconds, lanes/s, and the energies' largest
   relative difference from one card's (1e-4).

Prints every line beside the cards' names and power limits and a JSON
summary as its last line; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BEAM_BOX = (60.0, 20.0, 4.0)


def _sync_all():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _wall(fn, reps=1):
    """(the last result, wall seconds a call) over every card."""
    _sync_all()
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync_all()
    return out, (time.perf_counter() - t) / reps


def _beam(scale, dtype, device):
    import topopteval_tpu_torch as tt
    mesh = tt.generate_grid_tet(25 * scale // 2, 4 * scale, scale,
                                (0, 0, 0), BEAM_BOX)
    mesh.structured_info = None          # the block-ELL route
    p = tt.setup_problem(mesh, dtype=dtype, device=device)
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="cards to use (default: every visible card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="the scale-2 beam and a 20x8x2 sweep of 8x4 lanes")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    if not on_cpu and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < 2):
        print("multicard: needs two or more CUDA cards", file=sys.stderr)
        return 2
    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import _build
    from topopteval_tpu_torch.fem.operator import StiffnessOperator
    from topopteval_tpu_torch.ops import element_kernels as ek
    from topopteval_tpu_torch.parallel.halo import HaloShardedOperator
    from topopteval_tpu_torch.parallel.sharding import build_device_mesh

    tt.set_verbosity(False)
    if on_cpu:
        n = args.cards or 2
        cards = [torch.device("cpu")] * n
        smi = "cpu (host clock; no device metric)"
    else:
        n = args.cards or torch.cuda.device_count()
        cards = [torch.device("cuda", i) for i in range(n)]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", "; ")
        print(smi, flush=True)
        built = _build.build(["element_apply", "bell_apply"])
        print(f"[multicard] built {json.dumps(built)} | {smi}", flush=True)
    dev = cards[0]
    scale = 2 if args.small else 8
    f32, f64 = torch.float32, torch.float64
    failures = []
    summary = {"cards": n}

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            print(f"[multicard] FAIL {msg}", flush=True)

    # -- 1. the halo operator across the cards -------------------------------
    p8 = _beam(scale, f64, dev)
    mesh8 = p8.mesh
    mask8 = tt.free_mask_from_bcs(p8.n_dofs, p8.bcs)
    hop, build_s = _wall(lambda: HaloShardedOperator.build(
        mesh8, p8.lam, p8.mu, build_device_mesh(devices=cards),
        free_mask=mask8, dtype=f64))
    op = StiffnessOperator.build(
        mesh8.device(f64, dev), p8.lam, p8.mu,
        free_mask=torch.as_tensor(mask8, dtype=f64, device=dev))
    u = np.random.default_rng(8).standard_normal(mesh8.n_dofs)
    u_l, u_d = hop.to_local(u), torch.as_tensor(u, dtype=f64, device=dev)
    ek.reset_launch_counts()
    f_h = hop.matvec(u_l)
    _sync_all()
    b1 = ek.LAUNCHES["tet4_apply"]
    ref = op.matvec(u_d).cpu().numpy()
    err = float(np.abs(hop.from_local(f_h) - ref).max() / np.abs(ref).max())
    _, ms_halo = _wall(lambda: hop.matvec(u_l), reps=50)
    _, ms_one = _wall(lambda: op.matvec(u_d), reps=50)
    print(f"[multicard] 1 halo operator float64 scale {scale} "
          f"({mesh8.n_cells} tets, one shard on each of {n} cards): "
          f"build_s={build_s:.3f} "
          f"n_boundary={hop.plan.n_boundary} nbs_max={hop.nbs_max} "
          f"B1_launches_per_matvec={b1} rel_err_vs_one_card={err:.3e} "
          f"(tol 1e-12) wall_ms_per_matvec all cards={1e3 * ms_halo:.4f} "
          f"one card={1e3 * ms_one:.4f} | {smi}", flush=True)
    check(err <= 1e-12, f"halo matvec across cards off by {err:.3e}")
    # one tet4_apply kernel a shard; the CPU runs its plain version
    want = 0 if on_cpu else n
    check(b1 == want, f"{b1} tet4_apply launches a matvec, {want} expected")
    summary["halo"] = {"rel_err": err, "b1_per_matvec": b1,
                       "wall_ms_cards": 1e3 * ms_halo,
                       "wall_ms_one": 1e3 * ms_one, "build_s": build_s}
    del hop, op, f_h, u_l, u_d

    # -- 2. the sharded MG-PCG through solve_system(devices=n) ---------------
    cfg = tt.SolverConfig(method="cg", preconditioner="multigrid",
                          tolerance=1e-8, verbose=False)
    with open(os.path.join(os.path.dirname(tt.__file__), os.pardir, "data",
                           "oracle_energies.json")) as fh:
        oracle = json.load(fh)[f"tet_beam_scale_{scale}"]

    def phases(r):
        return {k: round(v, 3) for k, v in (r.timings or {}).items()}

    one, one_s = _wall(lambda: tt.solve_system(p8, cfg))
    warm, warm_s = _wall(lambda: tt.solve_system(p8, cfg))
    shd, shd_s = _wall(lambda: tt.solve_system(
        p8, cfg, devices=cards if on_cpu else n))
    rel = abs(shd.energy - oracle) / abs(oracle)
    rel_one = abs(one.energy - oracle) / abs(oracle)
    print(f"[multicard] 2 sharded MG-PCG float64 scale {scale} over {n} "
          f"cards: method={shd.method} iterations={shd.iterations} (one card "
          f"{one.iterations}) energy off the oracle {rel:.3e} (one card "
          f"{rel_one:.3e}; tol 1e-8; apart "
          f"{abs(shd.energy - one.energy) / abs(one.energy):.3e}); calls "
          f"{shd_s:.3f} s, one card {one_s:.3f} s then {warm_s:.3f} s; "
          f"phases sharded {json.dumps(phases(shd))}, one card "
          f"{json.dumps(phases(one))} then {json.dumps(phases(warm))} | "
          f"{smi}", flush=True)
    check(shd.method == "cg(multigrid,sharded)" and shd.converged,
          f"sharded MG-PCG: {shd.method}, converged {shd.converged}")
    check(shd.iterations == one.iterations == warm.iterations,
          f"sharded MG-PCG took {shd.iterations}, one card {one.iterations}")
    check(rel <= 1e-8 and rel_one <= 1e-8,
          f"MG-PCG energy off the oracle by {rel:.3e} sharded, {rel_one:.3e} "
          f"on one card")
    summary["mg_pcg"] = {"iterations": shd.iterations,
                         "one_card_iterations": one.iterations,
                         "rel_err": rel, "one_card_rel_err": rel_one,
                         "solve_s": shd.solve_time,
                         "one_card_solve_s": [one.solve_time,
                                              warm.solve_time]}
    del p8

    # -- 3. the design sweep at BASELINE config 5 ----------------------------
    dims = (20, 8, 2) if args.small else (80, 32, 8)
    mesh = tt.generate_grid_tet(*dims, (0, 0, 0), (6.0, 2.0, 1.0))
    p = tt.setup_problem(mesh, dtype=f32, device=dev)
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tip = tt.nodes_at_plane(mesh, 0, 6.0)
    material = tt.create_simp_material_model(1.0, 0.3, 1e-9, 3.0)
    B, L = (8 if args.small else 64), 4
    rng = np.random.default_rng(0)
    dens = rng.uniform(0.05, 1.0, (B, mesh.n_cells))
    dens[:, : mesh.n_cells // 4] = 1.0
    loads = np.zeros((L, mesh.n_dofs))
    dirs = [(0, 0, -1.0), (0, -1.0, 0), (1.0, 0, 0), (0, 0.7, -0.7)]
    for j in range(L):
        for c, v in enumerate(dirs[j]):
            loads[j, tip * 3 + c] = v / tip.size

    def sweep(**extra):
        return _wall(lambda: tt.evaluate_design_batch(
            p, dens, loads, material=material, tol=1e-6, maxiter=20000,
            **extra))

    runs = {"one card, pairs": sweep(),
            f"one card, pairs, one card's part of {n}": _wall(
                lambda: tt.evaluate_design_batch(
                    p, dens[:B // n], loads, material=material, tol=1e-6,
                    maxiter=20000)),
            f"{n} cards, pairs": sweep(devices=cards),
            f"{n} cards, einsum": sweep(devices=cards, lane_chunk=B)}
    e_ref = runs["one card, pairs"][0][0]
    summary["sweep"] = {}
    for name, ((e, it, cv), sec) in runs.items():
        e_b = e_ref[:e.shape[0]]
        rel = float(np.abs(e - e_b).max() / np.abs(e_b).max())
        print(f"[multicard] 3 sweep {e.shape[0]}x{L} lanes float32 on "
              f"{mesh.n_cells} tets, {name}: seconds={sec:.3f} lanes_per_s="
              f"{e.size / sec:.3f} converged={int(cv.sum())}/{cv.size} "
              f"lane_iterations_total={int(it.sum())} max_rel_diff_vs_one_"
              f"card={rel:.3e} (tol 1e-4) | {smi}", flush=True)
        check(cv.all() and rel <= 1e-4, f"sweep {name}: {rel:.3e} off, "
              f"{int((~cv).sum())} lanes unconverged")
        summary["sweep"][name] = {"seconds": sec,
                                  "lanes_per_s": e.size / sec,
                                  "rel_diff": rel}
    print(json.dumps({"ok": not failures, "card": smi, **summary}),
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
