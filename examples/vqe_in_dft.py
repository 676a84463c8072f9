"""VQE-in-DFT: run a variational quantum eigensolver on the embedded
Hamiltonian — the package's end-to-end purpose.

Mirrors the reference's ``docs/notebooks/7. vqe-in-dft.ipynb``, which
exports the embedded ``(constant, h1, h2)`` tuple to an external quantum
SDK; here the VQE is the built-in on-device statevector solver
(``nbed_tpu.solvers.run_vqe``): disentangled-UCCSD ansatz as one
``lax.scan`` of XOR-gather Pauli rotations, X-mask-grouped expectation
values, autodiff gradients, L-BFGS outer loop.

Pipeline: water / STO-3G, oxygen active, SPADE + mu projector, B3LYP
environment -> embedded Hamiltonian (qubit count reduced by the
embedding) -> VQE ground state vs the embedded-FCI oracle.

Run:  PYTHONPATH=. python examples/vqe_in_dft.py
"""

import pathlib

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from nbed_tpu import nbed  # noqa: E402
from nbed_tpu.solvers import run_vqe  # noqa: E402

xyz = (pathlib.Path(__file__).parent.parent
       / "tests" / "molecules" / "water.xyz").read_text()

driver = nbed(
    geometry=xyz,
    n_active_atoms=1,           # oxygen
    basis="STO-3G",
    xc_functional="b3lyp",
    projector="mu",
    localization="spade",
    run_ccsd_emb=False,
    run_fci_emb=True,           # the classical oracle to beat
)

const, h1, h2 = driver.mu["second_quantised"]
occ = np.asarray(driver.mu["scf"].mo_occ)
nelec = (int(occ[0].sum()), int(occ[1].sum()))
print(f"embedded Hamiltonian: {h1.shape[0]} qubits, "
      f"{nelec} active electrons")

res = run_vqe(const, h1, h2, nelec=nelec)
print(res)
print(f"  HF reference      : {res.e_reference:.8f} Ha")
print(f"  VQE (UCCSD)       : {res.e_vqe:.8f} Ha   "
      f"({res.n_params} parameters, {res.n_strings} Pauli rotations, "
      f"{res.n_iterations} L-BFGS iterations)")
print(f"  embedded FCI      : {driver.mu['e_fci']:.8f} Ha")
print(f"  VQE - FCI         : {res.e_vqe - driver.mu['e_fci']:+.2e} Ha")
