"""Bit-packed batched GF(2) Gaussian elimination for OSD post-processing.

The reference's OSD runs data-dependent Gaussian elimination over a dense
BitMatrix (/root/reference/src/decoders/belief_propagation_osd.jl:63-209).
Here it is re-architected as fixed-trip-count ``fori_loop`` passes over
rows bit-packed into uint32 words (32 columns per lane word):

  * every row operation (swap / XOR-eliminate) is a masked vectorized
    update over the whole ``[m, W]`` packed matrix;
  * pivot search is a masked argmax (first available row);
  * the reference's early-exit conditions become carried ``active`` flags
    (once false they stay false, reproducing the break);
  * the OSD-w candidate sweep evaluates pivot completions with
    popcount-parity dot products on the packed rows.

All functions here are single-lane and designed for ``jax.vmap`` over a
syndrome batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "pack_bits",
    "gf2_osd0",
    "gf2_osdw",
    "gf2_osd_cs",
    "gf2_eliminate",
    "osdw_sweep",
    "osd_cs_sweep",
]


def pack_bits(bits):
    """Pack a 0/1 array ``[..., n]`` into uint32 words ``[..., ceil(n/32)]``.

    Bit k of word w holds column ``32*w + k`` (little-endian within words).
    """
    n = bits.shape[-1]
    W = (n + 31) // 32
    pad = W * 32 - n
    b = bits.astype(jnp.uint32)
    if pad:
        b = jnp.pad(b, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    b = b.reshape(bits.shape[:-1] + (W, 32))
    shifts = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(b * shifts, axis=-1, dtype=jnp.uint32)


def _parity_dot(a, b):
    """``(a @ b) & 1`` as uint32 for 0/1 operands, exact on every platform.

    bf16 holds 0/1 exactly and the f32 accumulator holds every sum.  (The
    s8 x s8 -> s32 form returned wrong sums on an H100 with JAX 0.9:
    errors up to the contraction length, while the CPU was exact.)
    """
    s = jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
    return (s.astype(jnp.int32) & 1).astype(jnp.uint32)


def _col(Hp, j):
    """Extract 0/1 column ``j`` (traced scalar) from packed rows [m, W]."""
    word = jax.lax.dynamic_index_in_dim(Hp, j >> 5, axis=1, keepdims=False)
    return (word >> (j & 31).astype(jnp.uint32)) & jnp.uint32(1)


def _swap_rows(Hp, s, r, k):
    """Swap rows r and k of packed matrix Hp [m, W] and vector s [m]."""
    rows = jnp.arange(Hp.shape[0])
    hr = jnp.take(Hp, r, axis=0)
    hk = jnp.take(Hp, k, axis=0)
    is_r = (rows == r)[:, None]
    is_k = (rows == k)[:, None]
    Hp = jnp.where(is_r, hk[None, :], jnp.where(is_k, hr[None, :], Hp))
    sr = jnp.take(s, r)
    sk = jnp.take(s, k)
    s = jnp.where(rows == r, sk, jnp.where(rows == k, sr, s))
    return Hp, s


def gf2_osd0(Hp, bp_err, resid, n):
    """OSD-0: partial elimination + back-substitution (single lane).

    Faithful to the reference fast path
    (belief_propagation_osd.jl:63-125, Algorithm 2 of Roffe et al.):
    columns are assumed pre-sorted most-reliable-first.

    Args:
      Hp: ``[m, W]`` uint32 packed rows of the reliability-sorted H.
      bp_err: ``[n]`` uint32 0/1 BP hard decisions (sorted order).
      resid: ``[m]`` uint32 0/1 residual syndrome of bp_err
        (syndrome XOR H @ bp_err).
      n: number of columns (static).

    Returns:
      ``[n]`` uint32 0/1 correction in sorted column order; always
      syndrome-consistent when H has full row-relevance for the residual.
    """
    m, W = Hp.shape
    rows = jnp.arange(m)
    skip_all = ~jnp.any(resid != 0)

    def body(j, st):
        Hp, s, r, piv, active = st
        remaining = jnp.any((s != 0) & (rows >= r))
        active = active & (r < m) & remaining
        col = _col(Hp, j)
        avail = (col == 1) & (rows >= r)
        do = active & jnp.any(avail)
        # fold bp_err[j] into the residual using the *current* (partially
        # eliminated, pre-swap) column — reference order, osd fast path
        bpj = jnp.take(bp_err, j) == 1
        s = jnp.where(do & bpj, s ^ col, s)
        k = jnp.argmax(avail)
        Hp2, s2 = _swap_rows(Hp, s, r, k)
        col2 = _col(Hp2, j)
        elim = (col2 == 1) & (rows > r)
        pivrow = jnp.take(Hp2, r, axis=0)
        pivs = jnp.take(s2, r)
        Hp2 = jnp.where(elim[:, None], Hp2 ^ pivrow[None, :], Hp2)
        s2 = jnp.where(elim, s2 ^ pivs, s2)
        Hp = jnp.where(do, Hp2, Hp)
        s = jnp.where(do, s2, s)
        piv = jnp.where(do, piv.at[r].set(j), piv)
        r = r + do.astype(r.dtype)
        return Hp, s, r, piv, active

    piv0 = jnp.full((m,), n, jnp.int32)  # n == out-of-range sentinel
    Hp, s, r, piv, _ = jax.lax.fori_loop(
        0, n, body, (Hp, resid.astype(jnp.uint32), jnp.int32(0), piv0, jnp.bool_(True))
    )

    # back-substitution over pivots in reverse order
    def bs_body(idx, st):
        corr, s = st
        rr = r - 1 - idx
        valid = rr >= 0
        rr_c = jnp.maximum(rr, 0)
        c = jnp.take(piv, rr_c)
        colc = _col(Hp, c)
        val = jnp.take(s, rr_c)
        corr = jnp.where(valid, corr.at[c].set(val), corr)
        fold = valid & (val == 1)
        s = jnp.where(fold & (rows < rr_c), s ^ colc, s)
        return corr, s

    corr, _ = jax.lax.fori_loop(0, m, bs_body, (bp_err.astype(jnp.uint32), s))
    return jnp.where(skip_all, bp_err.astype(jnp.uint32), corr)


def gf2_osdw(Hp, bp_err, syndrome, osd_order, n):
    """OSD-w: Gauss–Jordan RREF + 2^w candidate sweep (single lane).

    Behaviorally faithful to belief_propagation_osd.jl:127-209 (full
    elimination with syndrome co-transform, then exhaustive assignment of
    the first ``osd_order`` most-reliable non-pivot columns, keeping the
    minimum-Hamming-weight completion), but re-architected for batches:

      * single-pass Gauss–Jordan with a *used-row mask* instead of row
        swaps — pivot columns (and therefore the solution, which depends
        only on them) are identical to the reference's swap-based
        forward-elimination + backward-diagonalization, while saving the
        whole m-trip diagonalization loop and two masked passes per trip;
      * the packed matrix lives transposed ``[W, m]`` so the large row
        axis m is the minor one (the natural ``[m, W]`` layout puts the
        short word axis there);
      * the column loop is a ``while_loop`` that exits as soon as the
        rank is exhausted (all m pivots found) rather than always running
        n trips.

    Args:
      Hp: ``[m, W]`` uint32 packed rows (reliability-sorted columns).
      bp_err: ``[n]`` uint32 0/1 BP hard decisions (sorted order).
      syndrome: ``[m]`` uint32 0/1.
      osd_order: static sweep order w (2^w candidates).
      n: static column count.
    """
    Ht, s, pivcol, r = gf2_eliminate(Hp.T, syndrome.astype(jnp.uint32), n)
    return osdw_sweep(Ht, s, pivcol, r, bp_err, osd_order, n)


def gf2_eliminate(Ht, s, n):
    """Gauss–Jordan RREF of packed columns (single lane, XLA path).

    Args:
      Ht: ``[W, m]`` uint32 — transposed packed rows (row axis minor;
        word w of row i at ``Ht[w, i]`` holds columns 32w..32w+31).
      s: ``[m]`` uint32 0/1 syndrome, co-transformed in place.
      n: static column count.

    Returns ``(Ht, s, pivcol [m] int32, r)`` where ``pivcol[i]`` is row
    i's pivot column (sentinel ``n`` = row unused) and ``r`` is the rank.
    """
    W, m = Ht.shape
    rows = jnp.arange(m)

    def cond(st):
        _, _, _, r, j = st
        return (j < n) & (r < m)

    def body(st):
        Ht, s, pivcol, r, j = st
        word = jax.lax.dynamic_index_in_dim(Ht, j >> 5, axis=0, keepdims=False)
        col = (word >> (j & 31).astype(jnp.uint32)) & jnp.uint32(1)  # [m]
        unused = pivcol == n
        avail = (col == 1) & unused
        found = jnp.any(avail)
        k = jnp.argmax(avail)
        is_k = rows == k
        # pivot row k's packed words, extracted as a masked lane-reduction
        # (gather-free: plays well inside fused loop bodies)
        pivrow = jnp.sum(jnp.where(is_k[None, :], Ht, jnp.uint32(0)), axis=1)  # [W]
        pivs = jnp.sum(jnp.where(is_k, s, jnp.uint32(0)))
        elim = (col == 1) & ~is_k & found
        Ht = jnp.where(elim[None, :], Ht ^ pivrow[:, None], Ht)
        s = jnp.where(elim, s ^ pivs, s)
        pivcol = jnp.where(found & is_k, j, pivcol)
        return Ht, s, pivcol, r + found.astype(r.dtype), j + 1

    pivcol0 = jnp.full((m,), n, jnp.int32)  # n == 'row unused' sentinel
    Ht, s, pivcol, r, _ = jax.lax.while_loop(
        cond, body, (Ht, s, pivcol0, jnp.int32(0), jnp.int32(0))
    )
    return Ht, s, pivcol, r


def osdw_sweep(Ht, s, pivcol, r, bp_err, osd_order, n):
    """2^w most-reliable-column sweep over an RREF system (single lane).

    Semantics match the reference's exhaustive candidate loop
    (belief_propagation_osd.jl:184-206): candidate x assigns the binary
    digits of x to the first ``osd_order`` most-reliable non-pivot
    columns (x = 0 keeps BP's hard decisions there — and beyond the
    information-set size the extra bits are masked, matching the
    reference's order clamp), completes the pivot columns from the
    transformed syndrome, and the minimum-Hamming-weight completion wins
    with first-candidate tie order.

    Re-architected as a matrix product: a candidate's pivot completion differs
    from the base candidate's only by an XOR of the swept RREF columns,
    so instead of a 2^w-trip serial loop re-deriving every completion by
    popcount over the whole packed system, all candidate weights come
    from ONE ``[2^w, w] @ [w, m]`` 0/1 matmul (chunked past 512
    candidates to bound memory) + row reductions, and only the argmin
    candidate is materialized.  Sweep cost is nearly flat in order,
    leaving the elimination, not the sweep, as the OSD-w bound.
    """
    is_piv = jnp.zeros((n,), bool).at[pivcol].set(True, mode="drop")
    mr_order = jnp.argsort(is_piv, stable=True)
    n_mr = n - r
    mr_mask = pack_bits(~is_piv)

    err0 = bp_err.astype(jnp.uint32)
    # base candidate (x = 0): BP's decisions on every non-pivot column
    err_mr0 = pack_bits(err0) & mr_mask
    base_parity = (
        jnp.sum(jax.lax.population_count(Ht & err_mr0[:, None]), axis=0)
        & jnp.uint32(1)
    ).astype(jnp.uint32)
    base_vals = s ^ base_parity  # [m] pivot assignments of the base
    piv_valid = (pivcol < n).astype(jnp.uint32)
    if osd_order == 0:
        return err0.at[pivcol].set(base_vals, mode="drop")

    w = osd_order
    mr_cols = mr_order[:w]
    b_idx = jnp.arange(w)
    swept = b_idx < n_mr  # bits past the information set are masked
    # the swept RREF columns as 0/1 row-vectors over checks: [w, m]
    C = (
        jnp.take(Ht, mr_cols >> 5, axis=0)
        >> (mr_cols & 31).astype(jnp.uint32)[:, None]
    ) & jnp.uint32(1)
    C = jnp.where(swept[:, None], C, jnp.uint32(0))
    base_bits = jnp.take(err0, mr_cols)  # [w]
    base_np_weight = jnp.sum(
        err0 * (~is_piv).astype(jnp.uint32), dtype=jnp.int32
    )

    def swept_bits(x):
        """Per-candidate values of the swept columns, [..., w] uint32."""
        patt = ((x[..., None] >> b_idx) & 1).astype(jnp.uint32)
        applied = (x[..., None] != 0) & swept
        return jnp.where(applied, patt, base_bits)

    def weights_of(x):
        """Completed-candidate Hamming weights for a chunk of x, [c]."""
        newbits = swept_bits(x)  # [c, w]
        delta = newbits ^ base_bits[None, :]
        flip = _parity_dot(delta, C)  # [c, m] pivot-assignment flips vs base
        piv_w = jnp.sum(
            (base_vals[None, :] ^ flip) * piv_valid[None, :],
            axis=1,
            dtype=jnp.int32,
        )
        np_w = base_np_weight + jnp.sum(
            newbits.astype(jnp.int32) - base_bits[None, :].astype(jnp.int32),
            axis=1,
        )
        return np_w + piv_w

    N = 1 << w
    chunk = min(N, 512)

    def scan_body(carry, x0):
        best_w, best_x = carry
        wts = weights_of(x0 + jnp.arange(chunk))
        i = jnp.argmin(wts)  # first minimum within the chunk
        better = wts[i] < best_w  # strict: earlier candidates win ties
        return (
            jnp.where(better, wts[i], best_w),
            jnp.where(better, (x0 + i).astype(jnp.int32), best_x),
        ), None

    (_, best_x), _ = jax.lax.scan(
        scan_body,
        (jnp.int32(n + 1), jnp.int32(0)),
        jnp.arange(0, N, chunk),
    )

    # materialize only the winner
    newbits_s = swept_bits(best_x)  # [w]
    delta_s = newbits_s ^ base_bits
    flip_s = _parity_dot(delta_s[None, :], C)[0]
    err = err0.at[mr_cols].set(newbits_s)  # pivot writes below override
    return err.at[pivcol].set(base_vals ^ flip_s, mode="drop")


def osd_cs_sweep(Ht, s, pivcol, r, bp_err, lam, n):
    """Combination-sweep OSD ("OSD-CS") over an RREF system (single lane).

    An extension beyond the reference's exhaustive 2^w sweep
    (belief_propagation_osd.jl:184-206): instead of every assignment of
    the first w non-pivot columns, the candidate set is

      * the base completion (BP's decisions on all non-pivot columns),
      * every single-bit flip of a non-pivot column (ALL n - r of them,
        not just the first w), and
      * every two-bit flip within the first ``lam`` most-reliable
        non-pivot columns,

    i.e. ``1 + (n-r) + lam*(lam-1)/2`` candidates — the "combination
    sweep" search of Roffe et al. 2020 ("Decoding across the quantum
    LDPC landscape"), which at equal wall-cost reaches far deeper than
    an exhaustive sweep (lam=60 costs ~1,771 pair candidates; an
    exhaustive sweep touching column 60 would need 2^60).

    The search never materializes candidates: flipping non-pivot column
    c changes the pivot completion by the RREF column C_c, so every
    single-flip weight comes from one ±1-weighted popcount pass over the
    packed matrix, and every pair weight from a ``[lam, m] @ [m, lam]``
    Gram matmul — weight(i,j) = w_i + w_j - 2*overlap(i,j).

    Ties: the minimum-weight candidate wins; among equals the earlier
    candidate in (base, single flips most-reliable-first, pairs in
    lexicographic (i, j)) order.  This ordering is this framework's own
    contract (no reference analog to match).

    Args / conventions identical to :func:`osdw_sweep`; ``lam`` is
    static.  Flip indices past the information set (j >= n - r) are
    masked out, so ``lam`` may exceed it safely.
    """
    m = s.shape[0]
    lam = int(min(lam, n))
    is_piv = jnp.zeros((n,), bool).at[pivcol].set(True, mode="drop")
    mr_order = jnp.argsort(is_piv, stable=True)  # non-pivot first, by reliability
    n_mr = n - r

    err0 = bp_err.astype(jnp.uint32)
    mr_mask = pack_bits(~is_piv)
    err_mr0 = pack_bits(err0) & mr_mask
    base_parity = (
        jnp.sum(jax.lax.population_count(Ht & err_mr0[:, None]), axis=0)
        & jnp.uint32(1)
    ).astype(jnp.uint32)
    base_vals = s ^ base_parity  # [m] pivot assignments of the base
    piv_valid = (pivcol < n).astype(jnp.int32)

    # v_i = +1 where flipping pivot row i's assignment 0->1 adds weight,
    # -1 where 1->0 removes it; dead rows contribute nothing
    v = (1 - 2 * base_vals.astype(jnp.int32)) * piv_valid  # [m]

    # t_c = sum_i v_i * RREF[i, c] for every column c, via one pass over
    # the packed words (no [n, m] unpack): scan Ht's word axis, expand
    # each word's 32 bits across lanes, reduce over rows
    bitsel = jnp.arange(32, dtype=jnp.uint32)

    def word_t(_, word):  # word: [m] uint32
        bits = (word[:, None] >> bitsel[None, :]) & jnp.uint32(1)  # [m, 32]
        return None, jnp.sum(v[:, None] * bits.astype(jnp.int32), axis=0)

    _, tw = jax.lax.scan(word_t, None, Ht)  # [W, 32]
    t = tw.reshape(-1)[:n]  # [n] in sorted-column order

    base_piv_w = jnp.sum(base_vals.astype(jnp.int32) * piv_valid)
    big = jnp.int32(1) << 30

    # single flips, enumerated most-reliable-first over non-pivot columns
    d_np = 1 - 2 * err0.astype(jnp.int32)  # np-weight change of flipping c
    delta1_nat = d_np + t  # [n] natural (sorted-column) order
    delta1 = jnp.take(delta1_nat, mr_order)  # enumeration order
    j_idx = jnp.arange(n)
    delta1 = jnp.where(j_idx < n_mr, delta1, big)
    j1 = jnp.argmin(delta1)  # first minimum = most-reliable winner
    best1 = delta1[j1]

    # pair flips within the first lam most-reliable non-pivot columns
    if lam >= 2:
        mr_lam = mr_order[:lam]  # [lam]
        C_lam = (
            jnp.take(Ht, mr_lam >> 5, axis=0)
            >> (mr_lam & 31).astype(jnp.uint32)[:, None]
        ) & jnp.uint32(1)  # [lam, m]
        Cf = C_lam.astype(jnp.float32)
        # overlap(i,j) = sum_i v * C_i * C_j  (exact in f32: |sums| <= m)
        G = jnp.dot(Cf * v[None, :].astype(jnp.float32), Cf.T,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
        d1l = jnp.take(delta1_nat, mr_lam)  # [lam]
        pair = d1l[:, None] + d1l[None, :] - 2 * G  # [lam, lam]
        li = jnp.arange(lam)
        valid = (li[:, None] < li[None, :]) & (li[None, :] < n_mr)
        pair = jnp.where(valid, pair, big)
        flat = jnp.argmin(pair)  # row-major = lexicographic (i, j)
        best2 = pair.reshape(-1)[flat]
        p_i, p_j = flat // lam, flat % lam
    else:
        best2 = big
        p_i = p_j = jnp.int32(0)

    # precedence: base (delta 0), then singles, then pairs — strict wins
    use1 = best1 < 0
    use2 = (best2 < 0) & (best2 < best1)
    c1 = jnp.where(use2, mr_order[p_i], jnp.where(use1, mr_order[j1], n))
    c2 = jnp.where(use2, mr_order[p_j], n)

    def col_of(c):
        cc = jnp.minimum(c, n - 1)
        word = jax.lax.dynamic_index_in_dim(Ht, cc >> 5, axis=0, keepdims=False)
        bits = (word >> (cc & 31).astype(jnp.uint32)) & jnp.uint32(1)
        return jnp.where(c < n, bits, jnp.uint32(0))

    flip = col_of(c1) ^ col_of(c2)  # [m] pivot-assignment flips
    err = err0.at[c1].set(1 - jnp.take(err0, jnp.minimum(c1, n - 1)), mode="drop")
    err = err.at[c2].set(1 - jnp.take(err0, jnp.minimum(c2, n - 1)), mode="drop")
    return err.at[pivcol].set(base_vals ^ flip, mode="drop")


def gf2_osd_cs(Hp, bp_err, syndrome, lam, n):
    """OSD-CS: Gauss–Jordan RREF + combination sweep (single lane).

    Same contract as :func:`gf2_osdw` with the exhaustive 2^w candidate
    sweep replaced by :func:`osd_cs_sweep`'s single+pair flip search.
    """
    Ht, s, pivcol, r = gf2_eliminate(Hp.T, syndrome.astype(jnp.uint32), n)
    return osd_cs_sweep(Ht, s, pivcol, r, bp_err, lam, n)
