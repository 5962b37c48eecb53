"""Unit-cell math: metric tensors, resolution (d-spacing), orthogonalization.

The port's own copy of careless_tpu/xtal/cell.py (numpy only, host-side):
d-spacings for DataSet.compute_dHKL and the formatter's cell check.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class UnitCell:
    a: float
    b: float
    c: float
    alpha: float = 90.0
    beta: float = 90.0
    gamma: float = 90.0

    @property
    def parameters(self):
        return (self.a, self.b, self.c, self.alpha, self.beta, self.gamma)

    def metric_tensor(self) -> np.ndarray:
        """Real-space metric tensor G (Angstrom^2)."""
        a, b, c = self.a, self.b, self.c
        ca, cb, cg = (np.cos(np.radians(x)) for x in (self.alpha, self.beta, self.gamma))
        return np.array([
            [a * a, a * b * cg, a * c * cb],
            [a * b * cg, b * b, b * c * ca],
            [a * c * cb, b * c * ca, c * c],
        ])

    def reciprocal_metric_tensor(self) -> np.ndarray:
        return np.linalg.inv(self.metric_tensor())

    @property
    def volume(self) -> float:
        return float(np.sqrt(np.linalg.det(self.metric_tensor())))

    def compute_d(self, hkl: np.ndarray) -> np.ndarray:
        """d-spacing in Angstroms for (N, 3) Miller indices."""
        hkl = np.atleast_2d(np.asarray(hkl, dtype=np.float64))
        gstar = self.reciprocal_metric_tensor()
        inv_d2 = np.einsum("ni,ij,nj->n", hkl, gstar, hkl)
        with np.errstate(divide="ignore"):
            return 1.0 / np.sqrt(inv_d2)

    def orthogonalization_matrix(self) -> np.ndarray:
        """Fractional -> Cartesian (PDB convention: a along x, b in xy plane)."""
        a, b, c = self.a, self.b, self.c
        al, be, ga = (np.radians(x) for x in (self.alpha, self.beta, self.gamma))
        cosal, cosbe, cosga = np.cos(al), np.cos(be), np.cos(ga)
        singa = np.sin(ga)
        v = np.sqrt(1 - cosal**2 - cosbe**2 - cosga**2 + 2 * cosal * cosbe * cosga)
        return np.array([
            [a, b * cosga, c * cosbe],
            [0.0, b * singa, c * (cosal - cosbe * cosga) / singa],
            [0.0, 0.0, c * v / singa],
        ])

    def is_similar(self, other: "UnitCell", length_tol: float = 0.05,
                   angle_tol: float = 1.0) -> bool:
        """Relative length tolerance + absolute angle tolerance (degrees)."""
        for x, y in ((self.a, other.a), (self.b, other.b), (self.c, other.c)):
            if abs(x - y) > length_tol * max(x, y):
                return False
        for x, y in ((self.alpha, other.alpha), (self.beta, other.beta),
                     (self.gamma, other.gamma)):
            if abs(x - y) > angle_tol:
                return False
        return True
