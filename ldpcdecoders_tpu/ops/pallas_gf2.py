"""Pallas (Triton) kernel: batched GF(2) Gauss–Jordan elimination for OSD.

The XLA form (ops/gf2.py::gf2_eliminate, vmapped) runs ~n serial column
trips, and each trip is at least one kernel launch that reads and writes
the whole ``[B, W, m]`` packed state in device memory.  Here one program
owns one lane: it loads the lane's packed matrix once, carries it as a
loop value (spread over the block's registers) through all n trips in a
single launch, and writes it back once.  The pivot row is found by a
block reduction.

The kernel only fits lanes whose packed matrix is small enough to live
in one block's registers (:func:`fits_block`): the (1000, 10, 9)
reference code is 32 words x 1024 rows x 4 B = 128 KB.  Wider matrices,
such as circuit-level detector error models, take the XLA form.

Semantics are identical to ``gf2_eliminate`` / ``gf2_osd0`` (same pivot
columns, same co-transformed syndrome, same row->pivot-column map with
sentinel n); the OSD-w candidate sweep stays in XLA
(ops/gf2.py::osdw_sweep).  Column j is read from the packed word
``j >> 5``; the outer loop walks words and keeps the current word's
column slice as its own loop value, so each trip makes one pass over the
state for the row update and one reduction for the pivot row.

Reference behavior being re-architected: the swap-based elimination of
the reference's belief_propagation_osd.jl:127-172.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["fits_block", "gf2_eliminate_pallas", "gf2_osd0_pallas"]

# state words a program may carry: 32 K x 4 B = 128 KB (the (1000, 10, 9)
# code's 32 x 1024 words), 128 a thread at 8 warps; ptxas (sm_90a) fits
# that in 202 registers without spilling
MAX_BLOCK_WORDS = 32 * 1024


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _block_dims(n: int, m: int) -> tuple[int, int]:
    """Power-of-two (words, rows) block of one lane's packed matrix."""
    return max(_pow2((n + 31) // 32), 2), max(_pow2(m), 16)


def fits_block(n: int, m: int) -> bool:
    """True when one lane's packed ``[W, m]`` matrix fits the kernel block."""
    wp, mp = _block_dims(n, m)
    return wp * mp <= MAX_BLOCK_WORDS


def _num_warps(wp: int, mp: int) -> int:
    # ~128 state words a thread, between 4 and 8 warps: on an H100 at the
    # full 128 KB block, 8 warps ran 14.1 ms per 1024 lanes without
    # spills, 16 warps 16.2 ms (128 registers, 64 B spilled), 32 warps
    # 22.0 ms
    return int(min(8, max(4, (wp * mp) // (128 * 32))))


def _col_bits(word, b):
    return (word >> b) & 1


def _elim_kernel(ht_ref, s_ref, ht_out, s_out, piv_out, *, n, wp, mp):
    iota_m = jax.lax.broadcasted_iota(jnp.int32, (mp,), 0)
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (wp, mp), 0)

    def word_trip(w, carry):
        ht, s, piv = carry
        word = jnp.sum(jnp.where(iota_w == w, ht, 0), axis=0)  # [mp]

        def trip(b, carry):
            ht, word, s, piv = carry
            j = w * 32 + b
            col = _col_bits(word, b)
            avail = (col == 1) & (piv == n)
            k = jnp.min(jnp.where(avail, iota_m, mp))
            found = (k < mp) & (j < n)
            is_k = iota_m == k
            pivrow = jnp.sum(jnp.where(is_k[None, :], ht, 0), axis=1)  # [wp]
            pivw = jnp.sum(jnp.where(is_k, word, 0))
            pivs = jnp.sum(jnp.where(is_k, s, 0))
            elim = (col == 1) & ~is_k & found
            ht = jnp.where(elim[None, :], ht ^ pivrow[:, None], ht)
            word = jnp.where(elim, word ^ pivw, word)
            s = jnp.where(elim, s ^ pivs, s)
            piv = jnp.where(is_k & found, j, piv)
            return ht, word, s, piv

        ht, _, s, piv = jax.lax.fori_loop(0, 32, trip, (ht, word, s, piv))
        return ht, s, piv

    init = (ht_ref[...], s_ref[...], jnp.full((mp,), n, jnp.int32))
    ht, s, piv = jax.lax.fori_loop(0, (n + 31) // 32, word_trip, init)
    ht_out[...] = ht
    s_out[...] = s
    piv_out[...] = piv


def _osd0_kernel(ht_ref, s_ref, bp_ref, s_out, piv_out, *, n, wp, mp):
    """OSD-0 partial elimination (ops/gf2.py::gf2_osd0 semantics).

    Used-row mask instead of row swaps and eager above-row elimination
    instead of lazy back-substitution: the pivot columns, stopping point
    and final pivot assignments (``corr[pivcol[k]] = s[k]``) are those of
    the reference-shaped XLA form, so the correction matches it bit for
    bit whenever the residual lies in H's column space — always the case
    for ``syndrome ^ H @ bp_err`` of a real syndrome.  (A residual outside
    it, on a rank-deficient H, has no consistent correction; the two forms
    may then return different inconsistent ones.)  The early stop
    ('residual exhausted outside the pivot space') is the carried
    ``active`` flag.
    """
    iota_m = jax.lax.broadcasted_iota(jnp.int32, (mp,), 0)
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (wp, mp), 0)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (wp * 32,), 0)
    bp = bp_ref[...]  # [wp * 32] 0/1 decisions

    def word_trip(w, carry):
        ht, s, piv, active = carry
        word = jnp.sum(jnp.where(iota_w == w, ht, 0), axis=0)

        def trip(b, carry):
            ht, word, s, piv, active = carry
            j = w * 32 + b
            unused = piv == n
            # residual left outside the pivot space? (checked on entry,
            # before this column's fold, as in the reference)
            rem = jnp.max(jnp.where(unused, s, 0))
            active = active & (rem > 0) & (j < n)
            col = _col_bits(word, b)
            avail = (col == 1) & unused
            k = jnp.min(jnp.where(avail, iota_m, mp))
            do = active & (k < mp)
            is_k = iota_m == k
            # fold bp_err[j] into the residual through the current column
            bpj = jnp.sum(jnp.where(iota_n == j, bp, 0))
            s = jnp.where(do & (bpj == 1), s ^ col, s)
            pivrow = jnp.sum(jnp.where(is_k[None, :], ht, 0), axis=1)
            pivw = jnp.sum(jnp.where(is_k, word, 0))
            pivs = jnp.sum(jnp.where(is_k, s, 0))
            elim = (col == 1) & ~is_k & do
            ht = jnp.where(elim[None, :], ht ^ pivrow[:, None], ht)
            word = jnp.where(elim, word ^ pivw, word)
            s = jnp.where(elim, s ^ pivs, s)
            piv = jnp.where(is_k & do, j, piv)
            return ht, word, s, piv, active

        ht, _, s, piv, active = jax.lax.fori_loop(
            0, 32, trip, (ht, word, s, piv, active))
        return ht, s, piv, active

    init = (ht_ref[...], s_ref[...], jnp.full((mp,), n, jnp.int32),
            jnp.bool_(True))
    _, s, piv, _ = jax.lax.fori_loop(0, (n + 31) // 32, word_trip, init)
    s_out[...] = s
    piv_out[...] = piv


def _call(kernel, args, out_shapes, *, n, wp, mp, interpret):
    def spec(a):  # one lane per program
        return pl.BlockSpec((None, *a.shape[1:]),
                            lambda i: (i,) + (0,) * (len(a.shape) - 1))

    B = args[0].shape[0]
    return pl.pallas_call(
        functools.partial(kernel, n=int(n), wp=wp, mp=mp),
        grid=(B,),
        in_specs=[spec(a) for a in args],
        out_specs=tuple(spec(o) for o in out_shapes),
        out_shape=out_shapes,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(wp, mp),
                                             num_stages=1),
        interpret=interpret,
        name=kernel.__name__.lstrip("_"),
    )(*args)


def _lane_parallel(fn, sharding_rule):
    """Wrap ``fn`` (independent batch lanes) so that a batch-sharded
    caller runs it on each device's own lanes.

    XLA's partitioner cannot split a ``pallas_call``: left alone it would
    gather the batch onto every device.  Here the partitioner is told
    that the lanes are independent, so each device calls the kernel on
    its shard and nothing crosses devices."""
    wrapped = custom_partitioning(fn)

    def partition(mesh, arg_shapes, result_shape):
        spec = arg_shapes[0].sharding.spec
        batch = spec[0] if len(spec) else None

        def lanes(x):
            return NamedSharding(mesh, P(batch, *(None,) * (len(x.shape) - 1)))

        return (mesh, fn, jax.tree.map(lanes, result_shape),
                tuple(lanes(a) for a in arg_shapes))

    wrapped.def_partition(partition=partition, sharding_rule=sharding_rule)
    return wrapped


def _pad_state(Ht, s, n):
    """Pad ``[B, W, m]`` / ``[B, m]`` to the power-of-two block as int32.

    Zero rows are never chosen as pivots (their column bit is 0) and zero
    words hold no columns, so padding changes no result."""
    B, W, m = Ht.shape
    wp, mp = _block_dims(n, m)
    ht = jax.lax.bitcast_convert_type(Ht.astype(jnp.uint32), jnp.int32)
    ht = jnp.pad(ht, ((0, 0), (0, wp - W), (0, mp - m)))
    s = jnp.pad(s.astype(jnp.int32), ((0, 0), (0, mp - m)))
    return ht, s, wp, mp


def gf2_eliminate_pallas(Ht, s, n, *, interpret=False):
    """Batched Gauss–Jordan RREF of packed columns.

    Args:
      Ht: ``[B, W, m]`` uint32 — per-lane transposed packed rows (word w
        of row i at ``[b, w, i]``; see ops/gf2.py::gf2_eliminate).
      s: ``[B, m]`` uint32 0/1 syndromes, co-transformed.
      n: static column count.

    Returns ``(Ht' [B, W, m], s' [B, m], pivcol [B, m] int32)`` with
    ``pivcol[b, i]`` = row i's pivot column or the sentinel ``n``.
    """
    B, W, m = Ht.shape
    ht, sp, wp, mp = _pad_state(Ht, s, n)

    def run(ht, sp):
        b = ht.shape[0]
        return _call(
            _elim_kernel, (ht, sp),
            (jax.ShapeDtypeStruct((b, wp, mp), jnp.int32),
             jax.ShapeDtypeStruct((b, mp), jnp.int32),
             jax.ShapeDtypeStruct((b, mp), jnp.int32)),
            n=n, wp=wp, mp=mp, interpret=interpret,
        )

    ht2, s2, piv = _lane_parallel(run, "b w m, b m -> b w m, b m, b m")(ht, sp)
    ht2 = jax.lax.bitcast_convert_type(ht2[:, :W, :m], jnp.uint32)
    return ht2, s2[:, :m].astype(jnp.uint32), piv[:, :m]


def gf2_osd0_pallas(Ht, resid, bp_err, n, *, interpret=False):
    """Batched OSD-0 elimination; returns the ``[B, n]`` correction.

    Args:
      Ht: ``[B, W, m]`` uint32 transposed packed rows (sorted columns).
      resid: ``[B, m]`` uint32 0/1 residual syndrome of ``bp_err``.
      bp_err: ``[B, n]`` 0/1 BP hard decisions (sorted order).
      n: static column count.
    """
    B, W, m = Ht.shape
    ht, sp, wp, mp = _pad_state(Ht, resid, n)
    bp = jnp.pad(bp_err.astype(jnp.int32), ((0, 0), (0, wp * 32 - n)))

    def run(ht, sp, bp):
        b = ht.shape[0]
        return _call(
            _osd0_kernel, (ht, sp, bp),
            (jax.ShapeDtypeStruct((b, mp), jnp.int32),
             jax.ShapeDtypeStruct((b, mp), jnp.int32)),
            n=n, wp=wp, mp=mp, interpret=interpret,
        )

    s_fin, piv = _lane_parallel(run, "b w m, b m, b c -> b m, b m")(ht, sp, bp)
    # corr = bp_err with pivot columns reassigned from the residual
    # (sentinel n indices are dropped by the scatter mode)
    corr = bp_err.astype(jnp.uint32)
    return jax.vmap(lambda c, p, sv: c.at[p].set(sv, mode="drop"))(
        corr, piv[:, :m], s_fin[:, :m].astype(jnp.uint32)
    )
