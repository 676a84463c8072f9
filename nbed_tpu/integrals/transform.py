"""AO -> MO integral transforms as GEMM-shaped einsum chains.

Replaces PySCF ``ao2mo.kernel``/``restore`` (reference ham_builder.py:128-149)
with the O(N^5) quarter-transform chain, jit-compiled.
"""

import jax
import jax.numpy as jnp

__all__ = ["ao_to_mo_1e", "ao_to_mo_eri"]


@jax.jit
def ao_to_mo_1e(h_ao, c_left, c_right=None):
    """C_left^T h C_right."""
    c_right = c_left if c_right is None else c_right
    return c_left.T @ h_ao @ c_right


@jax.jit
def ao_to_mo_eri(eri_ao, c1, c2=None, c3=None, c4=None):
    """(ij|kl)_MO = sum (mu nu|la si) C_mu i C_nu j C_la k C_si l.

    Quarter transforms (each a GEMM over a reshaped tensor) keep the cost at
    O(N^5) and map straight onto the GEMM units.
    """
    c2 = c1 if c2 is None else c2
    c3 = c1 if c3 is None else c3
    c4 = c1 if c4 is None else c4
    out = jnp.einsum("uvls,ui->ivls", eri_ao, c1, optimize=True)
    out = jnp.einsum("ivls,vj->ijls", out, c2, optimize=True)
    out = jnp.einsum("ijls,lk->ijks", out, c3, optimize=True)
    return jnp.einsum("ijks,sl->ijkl", out, c4, optimize=True)
