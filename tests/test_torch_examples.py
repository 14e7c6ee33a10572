"""The four workflow examples of the port (topopteval_tpu_torch/examples,
counterparts of examples/*.py) on the CPU, writing into a temporary
directory, with the checks their JAX twins make: the gravity deflection
within 5 % of Euler-Bernoulli, the imported-mesh multigrid solve
converged and within 2e-2 of the direct energy."""

import os

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.examples import (cantilever_beam,
                                           gravity_validation,
                                           imported_mesh_multigrid,
                                           simp_density_eval)

tt.set_verbosity(False)
torch.set_num_threads(1)


def _cpu(tmp_path):
    return ["--device", "cpu", "--out-dir", str(tmp_path)]


def test_cantilever_beam_example(tmp_path):
    r = cantilever_beam.main(_cpu(tmp_path))
    # the fixture's direct solve (its energy evaluated in float32) against
    # the fixture's float64 oracle (tests/test_torch_solve.py)
    assert r["method"] == "direct"
    assert abs(r["energy"] - 621.8542083316273) <= 1e-6 * 621.85
    assert r["volume"] == pytest.approx(1928.368597203464, rel=1e-12)
    for path in r["files"]:
        assert os.path.getsize(path) > 0
    assert os.path.basename(r["files"][2]) == "cantilever_beam-linear_bc.vtu"


def test_gravity_validation_example(tmp_path):
    r = gravity_validation.main(_cpu(tmp_path))
    assert 0.0 < r["error_percent"] < 5.0
    assert r["numerical"] > 0.0
    # the self-weight of the 10 x 1 x 1 steel beam
    np.testing.assert_allclose(r["total_force"],
                               [0.0, 0.0, -7850.0 * 9.81 * 10.0],
                               rtol=1e-12, atol=1e-6)


def test_imported_mesh_multigrid_example(tmp_path):
    r = imported_mesh_multigrid.main(_cpu(tmp_path))
    assert r["converged"] and r["iterations"] <= 500
    assert r["rel_err"] < 2e-2
    # float64 throughout: the two routes agree far inside that bar
    assert r["rel_err"] <= 1e-8


def test_simp_density_eval_example(tmp_path):
    r = simp_density_eval.main(_cpu(tmp_path))
    assert r["method"] == "direct"
    assert np.isfinite(r["energy"]) and r["energy"] > 0
    energies = np.asarray(r["sweep_energies"])
    assert np.all(np.isfinite(energies)) and np.all(energies > 0)
    # removing material below a higher cutoff never stiffens the beam
    assert np.all(np.diff(energies) >= 0)
    assert energies[0] == pytest.approx(r["energy"], rel=1e-6)
    for path in r["files"]:
        assert os.path.getsize(path) > 0
