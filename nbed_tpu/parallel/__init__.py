"""Multi-chip scale-out: conformer data parallelism + sharded Fock builds.

The reference has no distributed code at all (SURVEY.md §2.3); the natural
parallel dimensions for this domain are:

- **data parallel**: ``vmap`` over conformer/geometry batches (every
  integral/SCF kernel is a pure function of coordinates with static shapes),
  sharded over a mesh 'batch' axis;
- **model parallel**: the O(N^4) ERI supermatrices sharded over a 'model'
  axis, so the per-iteration J/K GEMMs run as partial contractions joined by
  collectives (XLA inserts psum/all-gather from sharding annotations; NCCL
  over NVLink on the GPU).
"""

from .embed_path import batched_embedding_energies, make_mu_embed_energy
from .sharding import (
    batched_hf_energies,
    batched_hf_gradients,
    make_mesh,
    make_sharded_df_ks,
    make_sharded_df_scf,
    make_sharded_scf,
    sharded_df_ks,
    sharded_df_scf,
    sharded_scf,
)

__all__ = ["make_mesh", "make_sharded_scf", "sharded_scf", "make_sharded_df_scf",
           "sharded_df_scf", "make_sharded_df_ks", "sharded_df_ks",
           "batched_hf_energies", "batched_hf_gradients",
           "make_mu_embed_energy", "batched_embedding_energies"]
