"""The one traffic generator: every input of a run, drawn from ``--seed``
by the parameters of a traffic mix (``traffic/<mix>.json``).

Each draw has a stream of its own: set-up, request ``i`` of the window,
and the sample the reference judges, so request ``i`` of a seed is the
same whatever the window's length.  Every request of a mix has the same
size; only the values differ from seed to seed.
"""

from __future__ import annotations

import numpy as np

SETUP, REQUEST, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 63), stream, index]))


def densities(spec: dict, n_cells: int, count: int,
              gen: np.random.Generator) -> np.ndarray:
    """[count, n_cells] SIMP densities uniform in [low, high], with the
    first ``solid_fraction`` of the elements (the quarter nearest the
    clamp, in the box's x-major element order) set to 1: config 5's
    fields (chip_smoke.py 15c, tools/bench_sweep.build_case)."""
    d = gen.uniform(spec["low"], spec["high"], (count, n_cells))
    d[:, : int(n_cells * spec["solid_fraction"])] = 1.0
    return d


def design(spec: dict, mesh: dict, gen: np.random.Generator) -> np.ndarray:
    """[C] SIMP densities of a Tet4 box (``mesh["dims"]`` hexes, six tets
    a hex, hexes x-major) from an optimised design (``designs/<base>.json``,
    over the same box):

    - the design resampled per hex: each hex takes the source hex that
      holds its centroid;
    - where ``move`` is not 0, moved as an optimiser's next iterate would
      be: uniform noise per hex drawn from ``gen``, box-filtered over
      ``filter`` hexes each side and scaled to at most ``move``, scales
      each density by (1 + noise), clipped to [0, 1].  Void at the lower
      bound stays there, as an optimiser's bound holds it; material and
      the gray boundary move.

    Every draw has the same base and move; the seed moves only the
    values."""
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "designs",
            f"{spec['base']}.json")) as fh:
        base = json.load(fh)
    src = np.asarray(base["density"], np.float64).reshape(base["dims"])
    axes = [(2 * np.arange(n) + 1) * bn // (2 * n)
            for n, bn in zip(mesh["dims"], base["dims"])]
    rho = src[np.ix_(*axes)]
    if spec["move"]:
        noise = _box_filter(gen.uniform(-1.0, 1.0, rho.shape),
                            int(spec["filter"]))
        rho = np.clip(rho * (1.0 + spec["move"] * noise
                             / np.abs(noise).max()), 0.0, 1.0)
    return np.repeat(rho.reshape(-1), 6)


def _box_filter(a: np.ndarray, r: int) -> np.ndarray:
    """Mean over the (2r + 1)^3 box around each entry, cut at the edges."""
    for ax in range(a.ndim):
        c = np.cumsum(a, axis=ax)
        c = np.concatenate([np.zeros_like(np.take(c, [0], axis=ax)), c],
                           axis=ax)
        n = a.shape[ax]
        hi = np.minimum(np.arange(n) + r + 1, n)
        lo = np.maximum(np.arange(n) - r, 0)
        shape = [1] * a.ndim
        shape[ax] = n
        a = (np.take(c, hi, axis=ax) - np.take(c, lo, axis=ax)) / (
            hi - lo).reshape(shape)
    return a


def direction_set(count: int) -> np.ndarray:
    """[count, 3] unit vectors spread evenly over the sphere (a Fibonacci
    lattice): the same set for every seed, so every run of a mix that
    cycles through it does the same work, in the order its seed draws."""
    k = np.arange(count) + 0.5
    z = 1.0 - 2.0 * k / count
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    r = np.sqrt(1.0 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def tip_load(n_dofs: int, nodes: np.ndarray, vector) -> np.ndarray:
    """The load vector of ``vector`` split equally over ``nodes``
    (the reference's apply_force, FiniteElementAnalysis.jl:392-418)."""
    f = np.zeros(n_dofs)
    v = np.asarray(vector, np.float64)
    for c in range(3):
        f[nodes * 3 + c] = v[c] / nodes.size
    return f
