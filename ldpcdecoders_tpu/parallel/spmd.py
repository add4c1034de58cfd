"""SPMD decoding over a device mesh: data-parallel + check-sharded paths.

Collectives actually needed (SURVEY.md §5):
  * steady-state batch-sharded decoding is embarrassingly parallel — the
    only cross-device traffic is the global early-stop reduction inside
    the ``while_loop`` condition;
  * ``decode_with_stats`` all-reduces convergence statistics (the FER
    accumulation collective);
  * ``make_check_sharded_minsum_fn`` is the 'tensor-parallel' analog for
    very large codes: the *check* axis of the Tanner graph is sharded over
    a 'model' mesh axis, and the per-variable message sums ride one
    ``psum`` per BP iteration (the structural cousin of sequence
    parallelism, over Tanner-graph edges instead of tokens).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..codes.graph import TannerGraph
from ..ops.clamps import MSG_CLAMP, TANH_CLAMP
from ..ops.exclusive import exclusive_prods
from .mesh import batch_sharding

__all__ = [
    "sharded_batch_decode",
    "decode_with_stats",
    "make_check_sharded_minsum_fn",
    "make_check_sharded_sumproduct_fn",
]


def sharded_batch_decode(decoder, syndromes, mesh: Mesh, *, data_axis: str = "data", seed: int = 0):
    """Data-parallel batch decode: shard the batch axis across the mesh.

    Works with any framework decoder; XLA partitions the jitted decode
    program across the mesh (GSPMD), inserting only the early-stop
    all-reduce.  Returns host numpy arrays like ``Decoder.batch_decode``.
    """
    from ..cache import ensure_default_cache

    ensure_default_cache()  # decoders entered via the parallel API skip
    # Decoder._call_decode, so enable the persistent compile cache here too
    syndromes = np.asarray(syndromes)
    B = syndromes.shape[0]
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names if a == data_axis]))
    if B % n_dev != 0:
        raise ValueError(f"batch {B} must divide the '{data_axis}' mesh size {n_dev}")
    syn_sharded = jax.device_put(
        jnp.asarray(syndromes), batch_sharding(mesh, 2, data_axis)
    )
    errors, converged, iters, aux = decoder._decode_batch(syn_sharded, seed)
    return np.asarray(errors), np.asarray(converged)


def decode_with_stats(decoder, syndromes, mesh: Mesh, *, data_axis: str = "data", seed: int = 0):
    """Sharded decode + all-reduced global convergence statistics.

    Returns ``(errors, converged, stats_dict)`` where the stats are the
    globally-reduced convergence fraction and mean iteration count (one
    all-reduce across the mesh, mirroring SURVEY.md §5's observability
    plan).
    """
    from ..cache import ensure_default_cache

    ensure_default_cache()
    syndromes = np.asarray(syndromes)
    syn_sharded = jax.device_put(
        jnp.asarray(syndromes), batch_sharding(mesh, 2, data_axis)
    )
    errors, converged, iters, aux = decoder._decode_batch(syn_sharded, seed)

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def _reduce(conv, iters):
        return (
            jnp.mean(conv.astype(jnp.float32)),
            jnp.mean(iters.astype(jnp.float32)),
            jnp.max(iters),
        )

    frac, mean_it, max_it = _reduce(jnp.asarray(converged), jnp.asarray(iters))
    stats = {
        "converged_fraction": float(frac),
        "mean_iters": float(mean_it),
        "max_iters_used": int(max_it),
        "batch_size": int(syndromes.shape[0]),
    }
    return np.asarray(errors), np.asarray(converged), stats


def sharded_mixed_decode(decoder, syndromes, erasures, mesh: Mesh, *,
                         data_axis: str = "data", per=None):
    """Data-parallel mixed-channel decode: shard the batch axis.

    The :class:`~ldpcdecoders_tpu.models.mixed.MixedChannelDecoder`
    takes an erasure mask (and a per-lane prior) alongside the
    syndromes; all three shard over the same leading batch axis and
    GSPMD partitions the single peel -> cond-gated-BP program (the only
    collective is the early-stop / cond all-reduce).  Returns host
    numpy ``(errors, ok)`` like ``MixedChannelDecoder.batch_decode``.
    """
    from ..cache import ensure_default_cache

    ensure_default_cache()
    syndromes = np.asarray(syndromes)
    erasures = np.asarray(erasures).astype(bool)
    B = syndromes.shape[0]
    if erasures.shape != (B, decoder.n):
        raise ValueError(
            f"expected erasures of shape [B={B}, {decoder.n}], got {erasures.shape}"
        )
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names if a == data_axis]))
    if B % n_dev != 0:
        raise ValueError(f"batch {B} must divide the '{data_axis}' mesh size {n_dev}")
    prior = decoder._native_prior(erasures, per)
    sh = batch_sharding(mesh, 2, data_axis)
    err, ok, _, _ = decoder._decode_fn(
        jax.device_put(jnp.asarray(syndromes), sh),
        jax.device_put(jnp.asarray(erasures), sh),
        jax.device_put(jnp.asarray(prior), sh),
    )
    return np.asarray(err), np.asarray(ok)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _minsum_rule(alpha, dtype):
    big = dtype(1e30)

    def rule(nu, cm_loc, syn_sign_loc):
        # single unrolled two-min + parity sweep (see models/minsum.py)
        dc = nu.shape[-1]
        masked = jnp.where(cm_loc, nu, big)
        mag = jnp.abs(masked)
        neg = masked < dtype(0.0)
        min1 = mag[..., 0:1]
        idx1 = jnp.zeros(min1.shape, jnp.int32)
        min2 = jnp.full_like(min1, big)
        parity = neg[..., 0:1]
        for k in range(1, dc):
            v = mag[..., k : k + 1]
            smaller = v < min1
            min2 = jnp.where(smaller, min1, jnp.minimum(min2, v))
            idx1 = jnp.where(smaller, k, idx1)
            min1 = jnp.where(smaller, v, min1)
            parity = jnp.logical_xor(parity, neg[..., k : k + 1])
        outs = []
        for k in range(dc):
            excl = jnp.where(idx1 == k, min2, min1)
            sflip = jnp.logical_xor(parity, neg[..., k : k + 1])
            mag_out = jnp.maximum(dtype(alpha) * excl, dtype(0.0))
            outs.append(jnp.where(sflip, -mag_out, mag_out))
        return syn_sign_loc[:, :, None] * jnp.concatenate(outs, axis=-1)

    return rule


def _sumproduct_rule(dtype):
    """Exact sum-product (tanh rule) in the LLR domain: cross-shard
    exclusive sums stay psum-compatible while the products remain local."""
    MAX_TANH = dtype(TANH_CLAMP)
    MAX_MSG = dtype(MSG_CLAMP)

    def rule(nu, cm_loc, syn_sign_loc):
        t = jnp.clip(jnp.tanh(dtype(0.5) * nu), -MAX_TANH, MAX_TANH)
        t = jnp.where(cm_loc, t, dtype(1.0))
        # exact leave-one-out product (tanh can be exactly 0 at nu == 0,
        # so division by the own factor would lose the sign there)
        fwd, bwd = exclusive_prods(t, axis=-1)
        excl = jnp.clip(fwd * bwd, -MAX_TANH, MAX_TANH)
        msg = dtype(2.0) * jnp.arctanh(excl)
        msg = jnp.clip(msg, -MAX_MSG, MAX_MSG)
        return syn_sign_loc[:, :, None] * msg

    return rule


def _make_check_sharded_fn(
    graph, per, max_iters, mesh, rule, *, data_axis, model_axis, dtype
):
    from ..cache import ensure_default_cache

    ensure_default_cache()  # sharded programs are the most expensive compiles
    D = mesh.shape[model_axis]
    m, n = graph.m, graph.n
    max_dc, max_dv = graph.max_dc, graph.max_dv
    m_pad = _round_up(m, D)

    chk_vars = np.zeros((m_pad, max_dc), np.int32)
    chk_vars[:m] = graph.chk_vars
    chk_mask = np.zeros((m_pad, max_dc), bool)
    chk_mask[:m] = graph.chk_mask
    L0 = dtype(np.log((1.0 - per) / per))

    # Per-shard var-major local adjacency: for every variable, the flat
    # indices of its edges *within this shard's* [m_loc, max_dc] message
    # block.  The per-variable partial sums then run as masked gathers
    # (the framework's fast path) instead of a scatter-add.
    m_loc = m_pad // D
    flat = graph.v2c_gather.astype(np.int64)  # [n, max_dv] into [m*max_dc]
    vmask = graph.var_mask
    shard_of = np.where(vmask, (flat // max_dc) // m_loc, -1)
    v2c_loc = np.zeros((D, n, max_dv), np.int32)
    vmask_loc = np.zeros((D, n, max_dv), bool)
    for d in range(D):
        sel = vmask & (shard_of == d)
        rank = np.cumsum(sel, axis=1) - 1
        rows, cols = np.nonzero(sel)
        v2c_loc[d, rows, rank[rows, cols]] = (
            flat[rows, cols] - d * m_loc * max_dc
        ).astype(np.int32)
        vmask_loc[d, rows, rank[rows, cols]] = True

    def local_iter(mu, total, syn_sign_loc, cv_loc, cm_loc):
        """One BP iteration on this shard's checks; returns new local mu."""
        # nu_{j->i} = total_j - mu_{i->j}, gathered for local checks
        Tg = jnp.take(total, cv_loc, axis=1)  # [B, m_loc, dc]
        nu = Tg - mu
        return rule(nu, cm_loc, syn_sign_loc)

    def spmd_body(syn, cv_loc, cm_loc, vl_loc, vm_loc):
        """Runs per-shard: syn [B_loc, m_loc]; constants are local slices."""
        B = syn.shape[0]
        m_loc = syn.shape[1]
        vl = vl_loc[0]  # [n, max_dv] local var-major gather indices
        vm = vm_loc[0]  # [n, max_dv] validity
        syn_sign = (1.0 - 2.0 * syn.astype(jnp.float32)).astype(dtype)
        syn_i = syn.astype(jnp.int32)

        state0 = (
            jnp.zeros((B, m_loc, max_dc), dtype),  # local mu
            jnp.full((B, n), L0, dtype),  # total llrs (replicated)
            jnp.zeros((B, n), jnp.float32),  # err (replicated)
            jnp.zeros((B,), bool),
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),
            jnp.int32(B),  # globally-reduced not-done count (carried so the
            # while condition itself stays collective-free)
        )

        def cond(st):
            it, n_undone = st[4], st[6]
            return (it < max_iters) & (n_undone > 0)

        def body(st):
            mu, total, err, done, it, iters, _ = st
            mu_new = local_iter(mu, total, syn_sign, cv_loc, cm_loc)
            # partial per-variable sums via the local var-major gather
            # (scatter-add here measured ~40x slower), then one psum
            # over the model axis
            g = jnp.take(mu_new.reshape(B, m_loc * max_dc), vl.reshape(-1), axis=1)
            g = g.reshape(B, n, max_dv)
            partial = jnp.sum(jnp.where(vm[None], g, dtype(0.0)), axis=-1)
            sum_mu = jax.lax.psum(partial, axis_name=model_axis)
            total_new = L0 + sum_mu
            err_new = (total_new < 0).astype(jnp.float32)

            active = ~done
            mu = jnp.where(active[:, None, None], mu_new, mu)
            total = jnp.where(active[:, None], total_new, total)
            err = jnp.where(active[:, None], err_new, err)

            # local syndrome check via an O(edges) gather over this shard's
            # own check adjacency (err is replicated [B, n], so no dense H
            # slice is ever needed — from_edges graphs shard cleanly),
            # then all-reduce of mismatch counts
            err_g = jnp.take(err.astype(jnp.int32), cv_loc, axis=1)
            syn_hat = (
                jnp.sum(jnp.where(cm_loc, err_g, 0), axis=-1) & 1
            )
            local_mis = jnp.sum(syn_hat != syn_i, axis=-1)
            mis = jax.lax.psum(local_mis, axis_name=model_axis)
            ok = mis == 0
            iters = jnp.where(ok & active, it + 1, iters)
            done = done | ok
            n_undone = jax.lax.psum(
                jnp.sum((~done).astype(jnp.int32)), axis_name=data_axis
            )
            return mu, total, err, done, it + 1, iters, n_undone

        mu, total, err, done, it, iters, _ = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.astype(jnp.int8), done, iters

    spec_data = P(data_axis, None)
    mapped = shard_map(
        spmd_body,
        mesh=mesh,
        in_specs=(
            P(data_axis, model_axis),  # syndromes [B, m_pad]
            P(model_axis, None),  # chk_vars
            P(model_axis, None),  # chk_mask
            P(model_axis, None, None),  # per-shard var-major gather
            P(model_axis, None, None),  # per-shard var-major mask
        ),
        out_specs=(spec_data, P(data_axis), P(data_axis)),
        check_vma=False,
    )

    cv_c = jnp.asarray(chk_vars)
    cm_c = jnp.asarray(chk_mask)
    vl_c = jnp.asarray(v2c_loc)
    vm_c = jnp.asarray(vmask_loc)

    d_data = mesh.shape[data_axis]

    @jax.jit
    def decode(syndromes):
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        if B % d_data != 0:
            raise ValueError(
                f"batch {B} must divide the '{data_axis}' mesh size {d_data}"
            )
        syn_pad = jnp.zeros((B, m_pad), syndromes.dtype).at[:, :m].set(syndromes)
        return mapped(syn_pad, cv_c, cm_c, vl_c, vm_c)

    return decode


def make_check_sharded_minsum_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    mesh: Mesh,
    *,
    data_axis: str = "data",
    model_axis: str = "model",
    alpha: float = 1.0,
    dtype=jnp.float32,
):
    """Min-sum BP with the *check* axis sharded over the 'model' mesh axis.

    Each model shard owns ``m/D`` checks and their check-to-variable
    messages; per-variable totals are formed with one ``psum`` over the
    model axis per iteration.  The batch axis is simultaneously sharded
    over 'data'.  Returns a jitted ``syndromes [B, m] -> (err [B, n] int8,
    converged [B] bool, iters [B])``.

    The per-shard syndrome check is an O(edges) gather over the shard's
    own check adjacency, so graphs compiled from sparse edge lists
    (``TannerGraph.from_edges`` — million-qubit HGP codes) shard without
    ever materializing a dense H.
    """
    return _make_check_sharded_fn(
        graph, per, max_iters, mesh, _minsum_rule(alpha, dtype),
        data_axis=data_axis, model_axis=model_axis, dtype=dtype,
    )


def make_check_sharded_sumproduct_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    mesh: Mesh,
    *,
    data_axis: str = "data",
    model_axis: str = "model",
    dtype=jnp.float32,
):
    """Exact sum-product BP (LLR/tanh rule) with the check axis sharded.

    The flagship algorithm's tensor-parallel form: identical update
    structure to :func:`make_check_sharded_minsum_fn` but with the
    clamped tanh-product check rule, so FER behavior matches LLR-domain
    sum-product rather than the min-sum approximation.  Like the min-sum
    form, it is dense-free: ``from_edges`` graphs are fully supported.
    """
    return _make_check_sharded_fn(
        graph, per, max_iters, mesh, _sumproduct_rule(dtype),
        data_axis=data_axis, model_axis=model_axis, dtype=dtype,
    )
