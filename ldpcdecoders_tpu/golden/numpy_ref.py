"""Pure-NumPy golden decoders — behavioral oracles for the batched decoders.

These transcribe the reference algorithms' *semantics* (SURVEY.md §2.2-2.5)
into single-syndrome, readable NumPy.  They exist only to validate the
batched JAX/Pallas implementations (exact outputs on small cases, FER parity
on statistical cases); they are never on any production path.

Reference behavior cites:
  * min-sum (not in the reference; this package's production decoder)
    in its plain flooding form, as in Chen & Fossorier 2002
  * BP sum-product, probability-ratio domain with serial prefix/suffix
    exclusive products and NaN guards:
    /root/reference/src/decoders/belief_propagation.jl:121-188
  * OSD-0 / OSD-w post-processing:
    /root/reference/src/decoders/belief_propagation_osd.jl:49-209
  * iterative bit-flip with random argmax tie-break:
    /root/reference/src/decoders/iterative_bitflip.jl:116-157
  * BP-OTS LLR-domain decoding with trapping-set biasing:
    /root/reference/src/decoders/bpots_decoder.jl:226-340
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bp_decode",
    "minsum_decode",
    "osd_postprocess",
    "bitflip_decode",
    "bpots_decode",
]


def bp_decode(H, syndrome, per, max_iters, dtype=np.float64):
    """Sum-product BP in the probability-ratio (delta = p0 - p1) domain.

    Returns (err[n] float, converged, log_probabs[n], iters).
    """
    H = np.asarray(H, dtype=np.uint8)
    syndrome = np.asarray(syndrome).astype(np.uint8)
    m, n = H.shape
    chk_nbrs = [np.flatnonzero(H[i]) for i in range(m)]
    var_nbrs = [np.flatnonzero(H[:, j]) for j in range(n)]

    ratio = dtype(per) / (dtype(1.0) - dtype(per))
    bit2chk = np.zeros((m, n), dtype=dtype)
    chk2bit = np.zeros((m, n), dtype=dtype)
    log_probabs = np.zeros(n, dtype=dtype)
    err = np.zeros(n, dtype=dtype)
    for j in range(n):
        bit2chk[var_nbrs[j], j] = ratio

    converged = False
    iters = 0
    for it in range(max_iters):
        iters = it + 1
        # check-node update: exclusive product of delta = 2/(1+q) - 1 with
        # the syndrome sign folded into the prefix, then map x -> (1-x)/(1+x)
        for i in range(m):
            temp = dtype((-1.0) ** syndrome[i])
            for j in chk_nbrs[i]:
                chk2bit[i, j] = temp
                temp = temp * (dtype(2.0) / (dtype(1.0) + bit2chk[i, j]) - dtype(1.0))
            temp = dtype(1.0)
            for j in chk_nbrs[i][::-1]:
                chk2bit[i, j] = chk2bit[i, j] * temp
                chk2bit[i, j] = (dtype(1.0) - chk2bit[i, j]) / (dtype(1.0) + chk2bit[i, j])
                temp = temp * (dtype(2.0) / (dtype(1.0) + bit2chk[i, j]) - dtype(1.0))
        # variable-node update with NaN guards on the running product
        for j in range(n):
            temp = ratio
            for i in var_nbrs[j]:
                bit2chk[i, j] = temp
                temp = temp * chk2bit[i, j]
                if np.isnan(temp):
                    temp = dtype(1.0)
            log_probabs[j] = np.log(dtype(1.0) / temp)
            err[j] = dtype(1.0) if temp >= 1 else dtype(0.0)
            temp = dtype(1.0)
            for i in var_nbrs[j][::-1]:
                bit2chk[i, j] = bit2chk[i, j] * temp
                temp = temp * chk2bit[i, j]
                if np.isnan(temp):
                    temp = dtype(1.0)
        if np.array_equal((H @ err.astype(np.int64)) % 2, syndrome.astype(np.int64)):
            converged = True
            break

    return err, converged, log_probabs, iters


def minsum_decode(H, syndrome, per, max_iters, alpha=1.0, beta=0.0,
                  dtype=np.float32):
    """Flooding normalized/offset min-sum in the LLR domain.

    ``per`` is a scalar or an ``[n]`` vector of channel error rates.  The
    check rule takes, for each edge, the least magnitude over the check's
    other edges, scaled by ``alpha`` less ``beta`` (clamped at 0), signed
    by the parity of the other edges and the syndrome bit.  Stops at the
    first iteration whose hard decisions reproduce the syndrome.

    Returns (err[n] int8, converged, llrs[n], iters).
    """
    H = np.asarray(H, dtype=np.uint8)
    syndrome = np.asarray(syndrome).astype(np.int64)
    m, n = H.shape
    per = np.broadcast_to(np.asarray(per, np.float64), (n,))
    L0 = np.log((1.0 - per) / per).astype(dtype)
    chk_nbrs = [np.flatnonzero(H[i]) for i in range(m)]
    alpha, beta = dtype(alpha), dtype(beta)
    v2c = np.where(H.astype(bool), L0[None, :], dtype(0)).astype(dtype)
    err = np.zeros(n, np.int8)
    llrs = L0.copy()
    for it in range(max_iters):
        c2v = np.zeros((m, n), dtype)
        for i, nb in enumerate(chk_nbrs):
            msgs = v2c[i, nb]
            mag, neg = np.abs(msgs), msgs < 0
            parity = (neg.sum() + syndrome[i]) % 2
            for k, j in enumerate(nb):
                # a lone edge sees the decoders' "no other edge" sentinel
                excl = np.min(np.delete(mag, k)) if nb.size > 1 else dtype(1e30)
                out = max(alpha * excl - beta, dtype(0))
                c2v[i, j] = -out if (parity ^ neg[k]) else out
        llrs = (L0 + c2v.sum(axis=0, dtype=dtype)).astype(dtype)
        v2c = np.where(H.astype(bool), llrs[None, :] - c2v, dtype(0)).astype(dtype)
        err = (llrs < 0).astype(np.int8)
        if np.array_equal((H.astype(np.int64) @ err) % 2, syndrome):
            return err, True, llrs, it + 1
    return err, False, llrs, max_iters


def _osd0(H, bp_err, s_target):
    """OSD-0 fast path: partial GF(2) elimination + back-substitution.

    H columns are assumed pre-sorted most-reliable-first; `s_target` is the
    residual syndrome of bp_err (syndrome XOR H@bp_err).
    """
    m, n = H.shape
    if not s_target.any():
        return bp_err.astype(bool).copy()

    H_work = H.astype(bool).copy()
    s_target = s_target.astype(bool).copy()
    piv_cols = []
    i = 0
    for j in range(n):
        if i >= m or not s_target[i:m].any():
            break
        rows = np.flatnonzero(H_work[i:m, j])
        if rows.size == 0:
            continue
        if bp_err[j]:
            s_target ^= H_work[:, j]
        k = i + rows[0]
        if k != i:
            H_work[[i, k]] = H_work[[k, i]]
            s_target[[i, k]] = s_target[[k, i]]
        elim = H_work[i + 1 :, j].copy()
        H_work[i + 1 :][elim] ^= H_work[i]
        s_target[i + 1 :][elim] ^= s_target[i]
        piv_cols.append(j)
        i += 1

    correction = bp_err.astype(bool).copy()
    for r in range(len(piv_cols) - 1, -1, -1):
        c = piv_cols[r]
        correction[c] = s_target[r]
        if correction[c]:
            s_target[:r] ^= H_work[:r, c]
    return correction


def _osd_w(H, syndrome, bp_err, osd_order):
    """OSD-w: full RREF with syndrome co-transform + 2^w candidate sweep."""
    H = H.astype(bool).copy()
    s = syndrome.astype(bool).copy()
    m, n = H.shape
    piv_rows, piv_cols = [], []
    i = j = 0
    while i < m and j < n:
        rows = np.flatnonzero(H[i:, j])
        if rows.size == 0:
            j += 1
            continue
        k = i + rows[0]
        if k != i:
            H[[i, k]] = H[[k, i]]
            s[[i, k]] = s[[k, i]]
        elim = H[i + 1 :, j].copy()
        H[i + 1 :][elim] ^= H[i]
        s[i + 1 :][elim] ^= s[i]
        piv_rows.append(i)
        piv_cols.append(j)
        i += 1
        j += 1
    r = len(piv_rows)
    # diagonalize: eliminate above each pivot
    for i, j in zip(piv_rows[::-1], piv_cols[::-1]):
        elim = H[:i, j].copy()
        H[:i][elim] ^= H[i]
        s[:i][elim] ^= s[i]

    if osd_order > n - r:
        osd_order = n - r

    most_reliable = np.setdiff1d(np.arange(n), np.asarray(piv_cols, dtype=np.int64))
    err = bp_err.astype(bool).copy()
    best_err = err.copy()
    min_weight = n + 1
    for x in range(2**osd_order):
        if x != 0:
            for b in range(osd_order):
                err[most_reliable[b]] = bool((x >> b) & 1)
        for i, j in zip(piv_rows, piv_cols):
            v = s[i]
            v ^= bool(np.logical_and(H[i, most_reliable], err[most_reliable]).sum() % 2)
            err[j] = v
        weight = int(err.sum())
        if weight < min_weight:
            min_weight = weight
            best_err = err.copy()
    return best_err


def osd_postprocess(H, syndrome, bp_err, log_probabs, osd_order=0):
    """Reliability sort + OSD, mirroring the reference decode! wrapper
    (/root/reference/src/decoders/belief_propagation_osd.jl:49-61)."""
    H = np.asarray(H).astype(bool)
    syndrome = np.asarray(syndrome).astype(bool)
    bp_err = np.asarray(bp_err).astype(bool)
    probs = np.exp(np.asarray(log_probabs, dtype=np.float64))
    reliability = np.maximum(probs, 1.0 - probs)
    perm = np.argsort(-reliability, kind="stable")
    H_sorted = H[:, perm]
    err_sorted = bp_err[perm]
    if osd_order == 0:
        resid = syndrome.copy()
        for j in range(H.shape[1]):
            if err_sorted[j]:
                resid ^= H_sorted[:, j]
        out = _osd0(H_sorted, err_sorted, resid)
    else:
        out = _osd_w(H_sorted, syndrome, err_sorted, osd_order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return out[inv]


def bitflip_decode(H, syndrome, max_iters, rng):
    """Gallager-B-style bit-flip with uniform-random argmax tie-break.

    Note: votes are zeroed once per decode, NOT per iteration — they
    accumulate across iterations, mirroring the reference exactly
    (reset! at iterative_bitflip.jl:84-88; no reset inside the loop at
    iterative_bitflip.jl:121-154).
    """
    H = np.asarray(H, dtype=np.int64)
    syndrome = np.asarray(syndrome).astype(np.int64)
    m, n = H.shape
    err = np.zeros(n, dtype=np.int64)
    votes = np.zeros(n, dtype=np.int64)
    converged = False
    for _ in range(max_iters):
        syn = (H @ err) % 2
        if np.array_equal(syn, syndrome):
            converged = True
            break
        mismatch = (syn != syndrome).astype(np.int64)
        votes += ((2 * mismatch - 1)[None, :] @ H).ravel()
        max_votes = votes.max()
        if max_votes >= 0:
            idxs = np.flatnonzero(votes == max_votes)
            flip = idxs[rng.integers(len(idxs))]
            err[flip] = 1 - err[flip]
        else:
            # "no bit is worth flipping" counts as convergence in the
            # reference (iterative_bitflip.jl:150-153)
            converged = True
            break
    return err, converged


def bpots_decode(H, syndrome, per, max_iters, T=9, C=2.0, trace=None):
    """LLR-domain BP with Ordered-Trapping-Set biasing (single syndrome).

    If ``trace`` is a list, a per-iteration record dict is appended after
    every iteration (decisions, pre-bias oscillation counters, mismatch,
    weight, best-tracking state, beliefs, bias nodes) — consumed by the
    bitwise parity tests against the batched JAX implementation.
    """
    H = np.asarray(H, dtype=np.uint8)
    syndrome = np.asarray(syndrome).astype(np.uint8)
    m, n = H.shape
    var_nbrs = [np.flatnonzero(H[:, j]) for j in range(n)]
    chk_nbrs = [np.flatnonzero(H[i, :]) for i in range(m)]

    MAX_TANH = 0.99999
    MAX_MSG = 100.0
    pi = np.log((1.0 - 2.0 * per / 3.0) / (2.0 * per / 3.0))
    Pi = np.full(n, pi)
    Omega = Pi.copy()
    mvc = np.zeros((m, n))
    mcv = np.zeros((m, n))
    oscillations = np.zeros(n, dtype=np.int64)
    prior_decisions = np.zeros(n, dtype=np.int64)
    best_decisions = np.zeros(n, dtype=np.int64)
    best_mismatch = m
    best_weight = n

    for it in range(1, max_iters + 1):
        for j in range(n):
            total = Omega[j] + mcv[var_nbrs[j], j].sum()
            for i in var_nbrs[j]:
                mvc[i, j] = total - mcv[i, j]
        for i in range(m):
            t = np.clip(np.tanh(0.5 * mvc[i, chk_nbrs[i]]), -MAX_TANH, MAX_TANH)
            for idx, j in enumerate(chk_nbrs[i]):
                prod = np.prod(np.delete(t, idx))
                if syndrome[i]:
                    prod = -prod
                prod = np.clip(prod, -MAX_TANH, MAX_TANH)
                mcv[i, j] = np.clip(2.0 * np.arctanh(prod), -MAX_MSG, MAX_MSG)

        llrs = np.array([Omega[j] + mcv[var_nbrs[j], j].sum() for j in range(n)])
        decisions = (llrs < 0.0).astype(np.int64)

        if it > 1:
            oscillations += decisions ^ prior_decisions
        prior_decisions = decisions.copy()

        mismatch = int((((H.astype(np.int64) @ decisions) % 2) != syndrome).sum())
        weight = int(decisions.sum())
        if mismatch < best_mismatch or (mismatch == best_mismatch and weight < best_weight):
            best_mismatch = mismatch
            best_weight = weight
            best_decisions = decisions.copy()
            if mismatch == 0:
                if trace is not None:
                    trace.append(
                        dict(
                            dec=decisions.copy(), osc=oscillations.copy(),
                            mis=mismatch, weight=weight, best_mis=best_mismatch,
                            best_w=best_weight, llrs=llrs.copy(), biased=False,
                            j1=None, j2=None,
                        )
                    )
                return best_decisions, True

        rec = dict(
            dec=decisions.copy(), osc=oscillations.copy(), mis=mismatch,
            weight=weight, best_mis=best_mismatch, best_w=best_weight,
            llrs=llrs.copy(), biased=False, j1=None, j2=None,
        )
        if mismatch > 0 and it % T == 0:
            Omega = Pi.copy()
            if oscillations.max() > 0:
                max_osc = oscillations.max()
                cand = oscillations == max_osc
                absllr = np.abs(llrs)
                j1 = int(np.argmin(np.where(cand, absllr, np.inf)))
                oscillations[j1] = 0
                Omega[j1] = -C
                j2 = int(np.argmin(absllr))
                Omega[j2] = -C
                rec.update(biased=True, j1=j1, j2=j2)
        if trace is not None:
            trace.append(rec)

    return best_decisions, False
