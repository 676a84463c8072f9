"""Molecular quadrature grids for XC integration.

Product spherical grids (Gauss-Legendre x uniform azimuth — exact for
spherical harmonics to high degree, and GEMM-shaped: one dense
(G, nao) AO-value matrix feeds the XC GEMMs) on Mura-Knowles radial shells,
with Becke fuzzy-cell partitioning. Replaces the reference's dependence on
PySCF/libxc grids (SURVEY.md §2.3 row 3).
"""

from .grid import MolecularGrid, build_grid, eval_aos

__all__ = ["MolecularGrid", "build_grid", "eval_aos"]
