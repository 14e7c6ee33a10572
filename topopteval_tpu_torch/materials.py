"""Material models: linear elasticity + SIMP density penalization
(counterpart of ``topopteval_tpu.materials``; reference:
src/FiniteElementAnalysis/FiniteElementAnalysis.jl:103-129, 616-634).

Host-side NumPy: the Lamé values are per-element arrays that the problem
moves to the device once, when it builds its operator.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def lame_parameters(youngs_modulus: float, poissons_ratio: float
                    ) -> Tuple[float, float]:
    """(E, nu) → (lambda, mu).

    reference: FiniteElementAnalysis.jl:103-109
    """
    E, nu = youngs_modulus, poissons_ratio
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    return lam, mu


# API-parity alias (reference export `create_material_model`)
create_material_model = lame_parameters


def constitutive_stress(strain, lam, mu):
    """Hooke's law sigma = lambda tr(eps) I + 2 mu eps on [...,3,3]
    tensors (NumPy arrays or tensors; reference:
    FiniteElementAnalysis.jl:126-129)."""
    tr = strain[..., 0, 0] + strain[..., 1, 1] + strain[..., 2, 2]
    if isinstance(strain, np.ndarray):
        eye = np.eye(3, dtype=strain.dtype)
    else:
        import torch
        eye = torch.eye(3, dtype=strain.dtype, device=strain.device)
    return lam * tr[..., None, None] * eye + 2.0 * mu * strain


def simp_youngs_modulus(density, E0, Emin, p):
    """E(rho) = Emin + (E0 - Emin) rho^p (reference:
    FiniteElementAnalysis.jl:623-624). Works on scalars or arrays."""
    return Emin + (E0 - Emin) * density ** p


@dataclasses.dataclass(frozen=True)
class SIMPMaterial:
    """SIMP material: E(rho) = Emin + (E0-Emin) rho^p.

    Defaults follow the reference's documented contract (Emin=1e-9,
    p=3.0, FiniteElementAnalysis.jl:600-611), as in the JAX package.
    """

    E0: float = 1.0
    nu: float = 0.3
    Emin: float = 1e-9
    p: float = 3.0

    def youngs_modulus(self, density):
        return simp_youngs_modulus(density, self.E0, self.Emin, self.p)

    def lame(self, density):
        """Per-density (lambda, mu); density may be an array."""
        return lame_parameters(self.youngs_modulus(density), self.nu)

    def __call__(self, density):
        """Closure parity with the reference's material_for_density
        (FiniteElementAnalysis.jl:622-631)."""
        return self.lame(density)


def create_simp_material_model(E0: float, nu: float, Emin: float = 1e-9,
                               p: float = 3.0) -> SIMPMaterial:
    """API-parity constructor (reference export
    `create_simp_material_model`, FiniteElementAnalysis.jl:616-634)."""
    return SIMPMaterial(E0=E0, nu=nu, Emin=Emin, p=p)


def elasticity_matrix(lam: float, mu: float, dtype=np.float64) -> np.ndarray:
    """6x6 isotropic D in Voigt order [xx, yy, zz, xy, yz, xz] with
    engineering shear strains."""
    D = np.zeros((6, 6), dtype=dtype)
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D
