"""Exclusive (leave-one-out) product/sum primitives over padded degree axes.

These replace the reference's serial per-node prefix/suffix accumulation
loops (/root/reference/src/decoders/belief_propagation.jl:135-177) with
vectorized cumulative scans along the (small, static) padded-degree axis,
preserving the exact left-to-right / right-to-left accumulation order —
including its behavior in the presence of zeros and infinities, which a
naive total/element division would destroy.

All helpers take the degree axis as a parameter; decoders use the
slot-major layout ``[B, slot, node]`` (degree axis 1) so the large node
axis stays the minor one.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["exclusive_prods", "guarded_exclusive_prod_scan"]


def _ones_slice(x, axis):
    shape = list(x.shape)
    shape[axis] = 1
    return jnp.ones(shape, x.dtype)


def exclusive_prods(x, axis=-1):
    """Return (fwd, bwd) exclusive cumulative products along ``axis``.

    ``fwd[k] = x[0] * ... * x[k-1]`` accumulated left-to-right;
    ``bwd[k] = x[d-1] * ... * x[k+1]`` accumulated right-to-left.
    ``fwd * bwd`` is the leave-one-out product with the same association
    order as two serial passes.
    """
    import jax

    ones = _ones_slice(x, axis)
    d = x.shape[axis]
    head = jax.lax.slice_in_dim(x, 0, d - 1, axis=axis)
    fwd = jnp.cumprod(jnp.concatenate([ones, head], axis=axis), axis=axis)
    rev = jnp.flip(x, axis=axis)
    head_r = jax.lax.slice_in_dim(rev, 0, d - 1, axis=axis)
    bwd = jnp.flip(
        jnp.cumprod(jnp.concatenate([ones, head_r], axis=axis), axis=axis), axis=axis
    )
    return fwd, bwd


def guarded_exclusive_prod_scan(x, init, *, axis=1, nan_reset=1.0):
    """Serial exclusive product with the reference's NaN guard.

    Mirrors the variable-node accumulation of
    /root/reference/src/decoders/belief_propagation.jl:152-177: a running
    product that is reset to ``nan_reset`` whenever it becomes NaN.  The
    guard makes the scan non-associative, so it is unrolled over the
    (small, static) degree axis.

    Args:
      x: factor array with the degree axis at ``axis``.
      init: running-product seed for the forward pass (the channel ratio),
        shaped like ``x`` with the degree axis removed.

    Returns:
      (excl, total): ``excl`` has ``x``'s shape — the guarded product of
      all factors except the one at that slot (forward prefix times
      backward suffix, reference order); ``total`` is the guarded product
      of all factors, seeded with ``init``.
    """
    d = x.shape[axis]
    one = jnp.ones_like(init)

    def slot(k):
        return jnp.take(x, k, axis=axis)

    fwd = []
    temp = init
    for k in range(d):
        fwd.append(temp)
        temp = temp * slot(k)
        temp = jnp.where(jnp.isnan(temp), nan_reset, temp)
    total = temp

    out = [None] * d
    temp = one
    for k in range(d - 1, -1, -1):
        out[k] = fwd[k] * temp
        temp = temp * slot(k)
        temp = jnp.where(jnp.isnan(temp), nan_reset, temp)

    return jnp.stack(out, axis=axis), total
