"""Grid XC evaluation: densities, energies, potentials — all on-device.

The potential matrices are derived from the energy-density closure by JAX
autodiff, so every functional in :mod:`nbed_tpu.dft.functionals` gets exact
``vrho``/``vsigma`` for free. The per-iteration cost is a handful of
(G, nao) x (nao, nao) GEMMs evaluated over grid chunks under
``lax.fori_loop`` with carried (exc, vxc) accumulators so peak memory is
bounded for large molecules (a ``lax.map`` would stack per-chunk outputs;
sequential accumulation is the same structure as the aux-chunked DF
exchange). The streaming variant
recomputes AO values per chunk (AO evaluation is a tiny fraction of the
GEMM cost), keeping memory at O(chunk * nao) instead of O(G * nao).
"""

import jax
import jax.numpy as jnp

from .functionals import resolve_functional

__all__ = ["make_xc_fn", "make_xc_fn_streaming"]


def _mask_thresh(dtype):
    """Density cut below which grid points are masked out of the XC math
    (coarser in f32, whose exponent range GGA intermediates leave first)."""
    return 1e-11 if dtype == jnp.float64 else 3e-6


def _chunk_math(terms, thresh):
    """Per-chunk energy + potential contributions given AO tables.

    When any functional term is tau-dependent (``fn.needs_tau``, meta-GGAs)
    the chunk additionally builds the per-spin kinetic-energy density
    tau_s = 1/2 sum_d (grad_d phi) D_s (grad_d phi) and the corresponding
    potential term V_tau[pq] = 1/2 sum_g v_tau(g) grad phi_p . grad phi_q
    (dtau/dD is symmetric in pq, so no +transpose).
    """
    needs_tau = any(getattr(fn, "needs_tau", False) for _, fn in terms)

    def e_density(ra, rb, gaa, gab, gbb, ta, tb):
        mask = (ra + rb) > thresh
        safe = lambda x: jnp.where(mask, x, 1.0)  # noqa: E731
        out = 0.0
        for coef, fn in terms:
            if getattr(fn, "needs_tau", False):
                out = out + coef * fn(safe(ra), safe(rb), safe(gaa),
                                      safe(gab), safe(gbb), safe(ta),
                                      safe(tb))
            else:
                out = out + coef * fn(safe(ra), safe(rb), safe(gaa),
                                      safe(gab), safe(gbb))
        return jnp.where(mask, out, 0.0)

    def one_chunk(ao_c, grad_c, w_c, dm):
        def total_e(ra, rb, gaa, gab, gbb, ta, tb):
            return jnp.sum(w_c * e_density(ra, rb, gaa, gab, gbb, ta, tb))

        ao_d = jnp.einsum("gp,spq->sgq", ao_c, dm)  # (2, C, nao)
        rho = jnp.einsum("sgq,gq->sg", ao_d, ao_c)
        grho = 2.0 * jnp.einsum("dgq,sgq->sdg", grad_c, ao_d)  # (2, 3, C)
        gaa = jnp.einsum("dg,dg->g", grho[0], grho[0])
        gbb = jnp.einsum("dg,dg->g", grho[1], grho[1])
        gab = jnp.einsum("dg,dg->g", grho[0], grho[1])
        if needs_tau:
            grad_d = jnp.einsum("dgp,spq->sdgq", grad_c, dm)
            tau = 0.5 * jnp.einsum("sdgq,dgq->sg", grad_d, grad_c)
            ta, tb = tau[0], tau[1]
        else:
            ta = tb = jnp.zeros_like(rho[0])
        exc, partials = jax.value_and_grad(
            total_e, argnums=(0, 1, 2, 3, 4, 5, 6)
        )(rho[0], rho[1], gaa, gab, gbb, ta, tb)
        # keep the expensive grid GEMMs in the working precision (f64 numpy
        # constants inside functionals otherwise promote under x64)
        dt = ao_c.dtype
        vra, vrb, vgaa, vgab, vgbb, vta, vtb = [p.astype(dt) for p in partials]

        def vmat(vr, vg_ss, vg_ab, grho_s, grho_t, vt):
            m = jnp.einsum("g,gp,gq->pq", vr, ao_c, ao_c)
            vec = 2.0 * vg_ss[None, :] * grho_s + vg_ab[None, :] * grho_t
            half = jnp.einsum("dg,dgp,gq->pq", vec, grad_c, ao_c)
            out = m + half + half.T
            if needs_tau:
                out = out + 0.5 * jnp.einsum("g,dgp,dgq->pq", vt, grad_c,
                                             grad_c)
            return out

        va = vmat(vra, vgaa, vgab, grho[0], grho[1], vta)
        vb = vmat(vrb, vgbb, vgab, grho[1], grho[0], vtb)
        return exc.astype(dt), jnp.stack([va, vb])

    return one_chunk


def _pad_chunks(arr, chunk, axis=0):
    g = arr.shape[axis]
    n_chunks = max(1, -(-g // chunk))
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, n_chunks * chunk - g)
    out = jnp.pad(arr, pad)
    new_shape = (
        out.shape[:axis] + (n_chunks, chunk) + out.shape[axis + 1:]
    )
    return out.reshape(new_shape), n_chunks


def make_xc_fn(ao, ao_grad, weights, xc_name: str, chunk: int = 131072):
    """``xc_fn(dm) -> (exc, vxc)`` from precomputed AO tables.

    Suitable when O(G * nao) AO storage fits; otherwise use
    :func:`make_xc_fn_streaming`.
    """
    terms = resolve_functional(xc_name)[0]
    if not terms:
        return None
    thresh = _mask_thresh(ao.dtype)
    one_chunk = _chunk_math(terms, thresh)

    ao_p, n_chunks = _pad_chunks(ao, chunk)
    grad_p, _ = _pad_chunks(ao_grad, chunk, axis=1)
    grad_p = jnp.swapaxes(grad_p, 0, 1)  # (n_chunks, 3, C, nao)
    w_p, _ = _pad_chunks(weights, chunk)

    def xc_fn(dm):
        if n_chunks == 1:
            return one_chunk(ao_p[0], grad_p[0], w_p[0], dm)

        def body(i, carry):
            exc, v = carry
            exc_c, v_c = one_chunk(ao_p[i], grad_p[i], w_p[i], dm)
            return exc + exc_c, v + v_c

        init = (jnp.zeros((), ao_p.dtype),
                jnp.zeros((2,) + dm.shape[-2:], ao_p.dtype))
        return jax.lax.fori_loop(0, n_chunks, body, init)

    return xc_fn


def make_xc_fn_streaming(mol, coords, points, weights, xc_name: str,
                         dtype=None, chunk: int = 32768):
    """``xc_fn(dm)`` that evaluates AO values per grid chunk on the fly —
    O(chunk * nao) peak memory, for molecules whose full AO table would not
    fit (e.g. a 26-atom B3LYP grid is ~2.4M points)."""
    from ..grids import eval_aos

    terms = resolve_functional(xc_name)[0]
    if not terms:
        return None
    dtype = points.dtype if dtype is None else dtype
    thresh = _mask_thresh(dtype)
    one_chunk = _chunk_math(terms, thresh)

    pts_p, n_chunks = _pad_chunks(points, chunk)
    # pad with far-away points so padded AO values vanish
    far = jnp.zeros_like(pts_p[..., 0]) + 1e6
    mask_rows = jnp.arange(n_chunks * chunk).reshape(n_chunks, chunk) \
        >= points.shape[0]
    pts_p = jnp.where(mask_rows[..., None], far[..., None], pts_p)
    w_p, _ = _pad_chunks(weights.astype(dtype), chunk)

    def xc_fn(dm):
        def chunk_contrib(pts_c, w_c):
            ao_c, grad_c = eval_aos(mol, pts_c, coords)
            return one_chunk(ao_c.astype(dtype), grad_c.astype(dtype), w_c,
                             dm)

        if n_chunks == 1:
            return chunk_contrib(pts_p[0], w_p[0])

        def body(i, carry):
            exc, v = carry
            exc_c, v_c = chunk_contrib(pts_p[i], w_p[i])
            return exc + exc_c, v + v_c

        init = (jnp.zeros((), dtype),
                jnp.zeros((2,) + dm.shape[-2:], dtype))
        return jax.lax.fori_loop(0, n_chunks, body, init)

    return xc_fn
