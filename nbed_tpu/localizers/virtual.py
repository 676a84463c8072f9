"""Virtual-orbital localization: concentric localization (CL) and PAOs.

CL (Claudino & Mayhall, JCTC 15, 6085 (2019); reference virtual/concentric.py)
truncates the embedded virtual space by repeated SVDs of overlap- and
Fock-projected virtuals — a batched dense-linear-algebra pipeline well
suited to device eigh/SVD. PAO (reference virtual/projected_atomic.py) builds
projected atomic orbitals for the Huzinaga path.
"""

import logging

import jax.numpy as jnp
import numpy as np

from ..chem.molecule import build_molecule
from ..integrals import overlap, overlap_cross

logger = logging.getLogger(__name__)

__all__ = ["VirtualLocalizer", "ConcentricLocalizer", "PAOLocalizer"]


class VirtualLocalizer:
    """Base class holding the active-atom count (reference virtual/base.py)."""

    def __init__(self, n_active_atoms: int):
        self._n_active_atoms = n_active_atoms


class ConcentricLocalizer(VirtualLocalizer):
    """Concentric localization of embedded virtuals.

    Mirrors reference virtual/concentric.py:53-262, including its shell
    bookkeeping (``shells`` records the column count after each accepted
    shell; ``singular_values`` records each SVD spectrum). Improvement over
    the reference: ``mo_occ``/``mo_energy`` are sliced to the new column
    count so downstream solvers stay consistent under truncation.
    """

    def __init__(self, embedded_scf, n_active_atoms: int, max_shells: int = 4,
                 projected_basis: str | None = None):
        super().__init__(n_active_atoms)
        self.embedded_scf = embedded_scf
        self.max_shells = max_shells
        self.projected_basis = projected_basis
        self.projected_overlap = None
        self.overlap_two_basis = None
        self.n_act_proj_aos = None
        self.shells = None
        self.singular_values = None

    def localize_virtual(self):
        """Localize virtuals; returns the modified embedded SCF solution."""
        scf = self.embedded_scf
        mol = scf.mol
        coords = jnp.asarray(scf.engine.coords)
        if self.projected_basis is None or (
            self.projected_basis.lower() == mol.basis.lower()
        ):
            proj_mol = mol
            s_proj = np.asarray(scf.engine.s)
            s_cross = s_proj
        else:
            xyz_lines = [f"{mol.natm}", ""]
            for sym, xyz in zip(mol.symbols, np.asarray(coords) * 0.52917721092):
                xyz_lines.append(f"{sym} {xyz[0]:.12f} {xyz[1]:.12f} {xyz[2]:.12f}")
            proj_mol = build_molecule("\n".join(xyz_lines) + "\n", self.projected_basis,
                                      charge=mol.charge, spin=mol.spin)
            s_proj = np.asarray(overlap(proj_mol))
            s_cross = np.asarray(overlap_cross(proj_mol, mol,
                                               jnp.asarray(proj_mol.coords), coords))

        n_act_proj_aos = int(proj_mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])
        self.projected_overlap = s_proj[:n_act_proj_aos, :n_act_proj_aos]
        self.overlap_two_basis = s_cross[:n_act_proj_aos, :]
        self.n_act_proj_aos = n_act_proj_aos

        mo_coeff = np.asarray(scf.mo_coeff)
        mo_occ = np.asarray(scf.mo_occ)
        fock = np.asarray(scf.get_fock())
        spinless = mo_coeff.ndim == 2

        if spinless:
            c_new, shells, sv, _ = self._localize_virtual_spin(mo_occ, mo_coeff, fock if fock.ndim == 2 else fock[0])
            scf.mo_coeff = c_new
            scf.mo_occ = mo_occ[: c_new.shape[-1]]
            scf.mo_energy = np.asarray(scf.mo_energy)[: c_new.shape[-1]]
            self.shells = shells
            self.singular_values = sv
        else:
            ca, sh_a, sv_a, rem_a = self._localize_virtual_spin(mo_occ[0], mo_coeff[0], fock[0])
            cb, sh_b, sv_b, rem_b = self._localize_virtual_spin(mo_occ[1], mo_coeff[1], fock[1])
            # Spin-asymmetric partitions can retain different per-spin
            # column counts (ragged CL).  The MO stack is rectangular, so
            # equalize by UN-truncating the narrower channel: append its own
            # leading kernel columns (S-orthonormal rotations of its virtual
            # space that CL would otherwise discard).  Strictly less
            # truncation for that spin — never worse than the ragged intent.
            # (Unreachable in the reference: its localizer force-equalizes
            # spin partitions, occupied/base.py:107-130.)
            if ca.shape[-1] != cb.shape[-1]:
                target = max(ca.shape[-1], cb.shape[-1])
                if ca.shape[-1] < target:
                    ca = np.concatenate((ca, rem_a[:, : target - ca.shape[-1]]), axis=-1)
                    sh_a = sh_a + [ca.shape[-1]]
                else:
                    cb = np.concatenate((cb, rem_b[:, : target - cb.shape[-1]]), axis=-1)
                    sh_b = sh_b + [cb.shape[-1]]
                logger.debug(
                    "Ragged per-spin CL truncation equalized to %d columns.", target
                )
            scf.mo_coeff = np.array([ca, cb])
            scf.mo_occ = np.asarray(scf.mo_occ)[:, : ca.shape[-1]]
            scf.mo_energy = np.asarray(scf.mo_energy)[:, : ca.shape[-1]]
            self.shells = (sh_a, sh_b)
            self.singular_values = (sv_a, sv_b)
        return scf

    def _localize_virtual_spin(self, occ, mo_coeff, fock_operator):
        """One spin channel (reference concentric.py:123-262).

        Returns ``(c_total, shells, singular_values, c_remainder)`` where
        ``c_remainder`` holds the S-orthonormal kernel columns CL discarded
        (empty unless truncation happened) — used to equalize ragged
        per-spin truncations in :meth:`localize_virtual`.
        """
        effective_virt = mo_coeff[:, occ == 0]
        left = np.linalg.inv(self.projected_overlap) @ self.overlap_two_basis @ effective_virt
        _, sigma, vt = np.linalg.svd(left.T @ self.overlap_two_basis @ effective_virt)
        singular_values = [sigma]

        c_total = mo_coeff[:, occ > 0]
        shell_size = int(np.sum(sigma[: self.n_act_proj_aos] >= 1e-15))
        right = vt.T
        v_span, v_ker = right[:, :shell_size], right[:, shell_size:]
        c_ispan = effective_virt @ v_span
        c_iker = effective_virt @ v_ker
        c_total = np.concatenate((c_total, c_ispan), axis=-1)
        shells = [c_total.shape[-1]]
        c_rem = c_iker[:, :0]

        if v_ker.shape[-1] == 0:
            logger.debug("No kernel for 0th shell; CL complete.")
        elif v_ker.shape[-1] == 1:
            c_total = np.concatenate((c_total, c_iker), axis=-1)
            shells.append(c_total.shape[-1])
        else:
            for ishell in range(self.max_shells):
                _, sigma, vt = np.linalg.svd(c_total.T @ fock_operator @ c_iker)
                singular_values.append(sigma)
                shell_size = int(np.sum(sigma[: self.n_act_proj_aos] >= 1e-15))
                if shell_size == 0:
                    c_total = np.concatenate((c_total, c_iker), axis=-1)
                    break
                right = vt.T
                v_span, v_ker = right[:, :shell_size], right[:, shell_size:]
                c_ispan = c_iker @ v_span
                c_total = np.concatenate((c_total, c_ispan), axis=-1)
                shells.append(c_total.shape[-1])
                if v_ker.shape[-1] > 1:
                    c_iker = c_iker @ v_ker
                    if ishell == self.max_shells - 1:
                        # loop exhausted: these kernel columns are dropped
                        c_rem = c_iker
                elif v_ker.shape[-1] == 1:
                    c_iker = c_iker @ v_ker
                    c_total = np.concatenate((c_total, c_iker), axis=-1)
                    shells.append(c_total.shape[-1])
                    break
                else:
                    break
        return c_total, shells, singular_values, c_rem


class PAOLocalizer(VirtualLocalizer):
    """Projected atomic orbitals for the embedded virtual space
    (reference virtual/projected_atomic.py:14-132; Huzinaga path only)."""

    def __init__(self, global_scf, n_active_atoms: int, c_loc_occ,
                 norm_cutoff: float = 0.05, overlap_cutoff: float = 1e-5):
        super().__init__(n_active_atoms)
        self.global_scf = global_scf
        self.norm_cutoff = norm_cutoff
        self.overlap_cutoff = overlap_cutoff
        self.c_loc_occ = np.asarray(c_loc_occ)

    def localize_virtual(self):
        mol = self.global_scf.mol
        n_act_aos = int(mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])
        s = np.asarray(self.global_scf.engine.s)
        if self.c_loc_occ.ndim == 2:
            return _pao_spin(self.c_loc_occ, s, n_act_aos,
                             self.norm_cutoff, self.overlap_cutoff)
        return np.array([
            _pao_spin(self.c_loc_occ[0], s, n_act_aos,
                      self.norm_cutoff, self.overlap_cutoff),
            _pao_spin(self.c_loc_occ[1], s, n_act_aos,
                      self.norm_cutoff, self.overlap_cutoff),
        ])


def _pao_spin(c_loc_occ, ao_overlap, n_act_aos, norm_cutoff, overlap_cutoff):
    """PAOs for one spin: projector, norm truncation, renormalise,
    overlap-eigh canonicalisation (reference projected_atomic.py:74-132)."""
    projector = np.eye(ao_overlap.shape[-1]) - c_loc_occ @ c_loc_occ.T @ ao_overlap
    norms = np.einsum("ji,ji->i", projector[:n_act_aos],
                      (ao_overlap @ projector)[:n_act_aos])
    truncated = projector[:, np.abs(norms) > norm_cutoff]
    if truncated.shape[-1] == 0:
        logger.warning("No projected atomic orbitals above the norm cutoff.")
        return truncated
    renorm = truncated / np.sqrt(np.einsum("ij,ij->j", truncated, truncated))
    eigvals, _ = np.linalg.eigh(renorm.T @ ao_overlap @ renorm)
    final = renorm[:, np.abs(eigvals) > overlap_cutoff]
    if final.shape[-1] == 0:
        logger.warning("No projected atomic orbitals; active region may have "
                       "no virtual AOs.")
    return final
