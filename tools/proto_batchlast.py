"""Prototype: batch-LAST min-sum layout for wide detector models.

The slot-major layout makes the node axis minor; on the bb144
circuit DEM the per-iteration gather then materializes batch-minor
([dc*m, B]) and XLA inserts a full transpose copy to the node-minor
elementwise layout — measured 4x below the flagship edge-iteration
rate.  This prototype keeps B minor-most EVERYWHERE: messages live as
``[slots, B]``, gathers are over axis 0 (naturally batch-minor), the
syndrome test is a dense ``[m, n] @ [n, B]`` MXU matmul.

Numerics: identical update rule (argmin-free two-min, per-lane
freezing, check_every grid) — validated here against the production
decoder on random syndromes, then timed on the bb144 DEM.
"""

import argparse
import time

import numpy as np


def make_minsum_bl(graph, max_iters, *, alpha=1.0, dtype=None,
                   check_every=8, lane_damping=True):
    import jax
    import jax.numpy as jnp

    dtype = jnp.float32 if dtype is None else dtype
    m, n = graph.m, graph.n
    max_dc, max_dv = graph.max_dc, graph.max_dv
    c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()
    c2v = jnp.asarray(c2v_t)  # [dc*m] indices into dv*n
    v2c = jnp.asarray(v2c_t)  # [dv*n] indices into dc*m
    chk_mask = jnp.asarray(chk_mask_t)[:, :, None]  # [dc, m, 1]
    var_mask = jnp.asarray(var_mask_t)[:, :, None]  # [dv, n, 1]
    H = jnp.asarray(graph.H.astype(np.float32))  # [m, n] dense
    alpha = dtype(alpha)
    big = dtype(1e30)

    def decode(syndromes, L0, gamma):
        B = syndromes.shape[0]
        syn_bT = syndromes.T  # [m, B]
        syn_f = syn_bT.astype(jnp.float32)
        syn_flip = syn_bT.astype(bool)[None]  # [1, m, B]
        L0 = jnp.broadcast_to(L0.reshape(-1, 1), (n, B)).astype(dtype)
        gam = jnp.asarray(gamma, dtype)
        gam = (gam.reshape(1, 1, B) if gam.ndim == 1
               else gam.T.reshape(1, n, B))

        nu0 = jnp.broadcast_to(L0[None], (max_dv, n, B))
        state0 = (nu0, jnp.zeros((n, B), jnp.float32), L0,
                  jnp.zeros((B,), bool), jnp.int32(0),
                  jnp.zeros((B,), jnp.int32))

        def cond(st):
            _, _, _, done, it, _ = st
            return (it < max_iters) & ~jnp.all(done)

        def body(st):
            nu, err, llrs, done, it, iters = st
            Ng = jnp.take(nu.reshape(max_dv * n, B), c2v,
                          axis=0).reshape(max_dc, m, B)
            masked = jnp.where(chk_mask, Ng, big)
            mag = jnp.abs(masked)
            neg = masked < dtype(0.0)
            min1 = jnp.min(mag, axis=0)
            eq1 = mag == min1[None]
            unique = jnp.sum(eq1, axis=0, dtype=jnp.int32) == 1
            min2 = jnp.min(jnp.where(eq1, big, mag), axis=0)
            parity = (jnp.sum(neg, axis=0, dtype=jnp.int32) & 1).astype(
                bool)[None]
            excl = jnp.where(eq1 & unique[None], min2[None], min1[None])
            flip = jnp.logical_xor(jnp.logical_xor(parity, neg), syn_flip)
            mag_out = jnp.maximum(alpha * excl, dtype(0.0))
            mu = jnp.where(flip, -mag_out, mag_out)

            Mg = jnp.take(mu.reshape(max_dc * m, B), v2c,
                          axis=0).reshape(max_dv, n, B)
            Mg = jnp.where(var_mask, Mg, dtype(0.0))
            total = L0 + jnp.sum(Mg, axis=0)
            nu_n = total[None] - Mg
            nu_n = gam * nu + (dtype(1.0) - gam) * nu_n
            errn = (total < 0).astype(jnp.float32)
            active = ~done
            err = jnp.where(active[None, :], errn, err)
            llrs = jnp.where(active[None, :], total, llrs)
            is_check = (jnp.mod(it + 1, check_every) == 0) | (
                it + 1 >= max_iters)
            ok = jax.lax.cond(
                is_check,
                lambda e: jnp.all(
                    jnp.mod(jnp.dot(H, e,
                                    preferred_element_type=jnp.float32),
                            2.0) == syn_f, axis=0),
                lambda e: jnp.zeros((B,), bool),
                err)
            iters = jnp.where(ok & active, it + 1, iters)
            return nu_n, err, llrs, done | ok, it + 1, iters

        _, err, llrs, done, it, iters = jax.lax.while_loop(
            cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.T.astype(jnp.int8), done, iters, llrs.T

    return decode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--p", type=float, default=0.003)
    ap.add_argument("--bucket", type=int, default=128)
    ap.add_argument("--members", type=int, default=6)
    ap.add_argument("--deep", type=int, default=1000)
    ap.add_argument("--validate", action="store_true")
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ldpcdecoders_tpu.codes.graph import TannerGraph
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn

    if a.validate:
        # CPU numerics parity vs the production lane-damping decoder
        rng = np.random.default_rng(0)
        H = (rng.random((40, 300)) < 0.08).astype(np.uint8)
        H[:, H.sum(axis=0) == 0] = 1
        g = TannerGraph.from_pcm(H)
        pr = np.clip(rng.random(300) * 0.02, 1e-4, 0.02)
        L0 = jnp.asarray(np.log((1 - pr) / pr), jnp.float32)
        x = rng.random((16, 300)) < pr * 10
        det = ((x @ H.T) % 2).astype(np.uint8)
        gam = np.concatenate([np.full(8, 0.0, np.float32),
                              np.full(8, 0.35, np.float32)])
        ref = jax.jit(make_minsum_decode_fn(
            g, float(pr.mean()), 64, lane_damping=True, check_every=4))
        new = jax.jit(make_minsum_bl(g, 64, check_every=4))
        e1, c1, i1, l1 = ref(jnp.asarray(det), L0, jnp.asarray(gam))
        e2, c2, i2, l2 = new(jnp.asarray(det), L0, jnp.asarray(gam))
        np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                                   rtol=1e-5, atol=1e-5)
        print("validate ok: batch-last == slot-major (err/conv/iters)")
        return

    from profile_deep import load_dem

    A, pr, O = load_dem(a.rounds, a.p)
    Ad = np.asarray(A.todense())
    g = TannerGraph.from_pcm(Ad)
    edges = int(Ad.sum())
    N = g.n
    rng = np.random.default_rng(0)
    x = rng.random((1024, N)) < pr[None, :]
    det = ((x.astype(np.uint8) @ Ad.T) % 2).astype(np.uint8)
    L0 = jnp.asarray(np.log((1 - pr) / pr).astype(np.float32))

    # stage-0 shape: uniform gamma via lane vector
    for dtype, tag in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        f = jax.jit(make_minsum_bl(g, 96, dtype=dtype, check_every=8))
        gam = jnp.full((1024,), 0.4, jnp.float32)
        d0 = jnp.asarray(det)
        t = time.time()
        r = f(d0, L0, gam)
        jax.block_until_ready(r)
        tc = time.time() - t
        t = time.time()
        for _ in range(3):
            r = f(d0, L0, gam)
        jax.block_until_ready(r)
        dt = (time.time() - t) / 3
        conv = float(np.asarray(r[1]).mean())
        print(f"stage0-bl[{tag}]: compile {tc:.1f}s warm {dt*1000:.0f}ms"
              f"/1024 conv={conv:.3f} edge-iters/s={1024*96*edges/dt:.3e}"
              f" shots/s={1024/dt:.0f}")

    # deep bucket shape
    Bb, K = a.bucket, a.members
    rows = np.empty((K, N), np.float32)
    rows[0] = 0.4
    for k in range(1, K):
        rows[k] = np.random.default_rng(0xD3E + k).uniform(-0.24, 0.66, N)
    f96 = jax.jit(make_minsum_bl(g, 96, check_every=8))
    conv0 = np.concatenate([
        np.asarray(f96(jnp.asarray(det[lo:lo+1024]), L0,
                       jnp.full((1024,), 0.4, jnp.float32))[1])
        for lo in range(0, det.shape[0], 1024)])
    hard = np.flatnonzero(~conv0)[:Bb]
    hard = np.concatenate([hard, np.repeat(hard[:1], Bb - hard.size)])
    syn_t = jnp.asarray(np.tile(det[hard], (K, 1)))
    gam_t = jnp.asarray(np.repeat(rows, Bb, axis=0))
    for dtype, tag in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        fd = jax.jit(make_minsum_bl(g, a.deep, dtype=dtype, check_every=8))
        t = time.time()
        r = fd(syn_t, L0, gam_t)
        jax.block_until_ready(r)
        tc = time.time() - t
        t = time.time()
        r = fd(syn_t, L0, gam_t)
        jax.block_until_ready(r)
        dt = time.time() - t
        convd = np.asarray(r[1]).reshape(K, Bb)
        it_hist = np.asarray(r[2]).reshape(K, Bb)
        solved = convd.any(axis=0)
        # solve-depth curve: fraction of shots solved by iteration cap c
        caps = [100, 250, 500, 1000, 2000]
        frac = {c: float((np.where(convd, it_hist, 10**9).min(axis=0)
                          <= c).mean()) for c in caps if c <= a.deep}
        lanes = K * Bb
        im = int(np.asarray(r[2]).max())
        print(f"deep-bl[{tag}] Bb={Bb} K={K} cap={a.deep}: compile "
              f"{tc:.1f}s warm {dt:.1f}s solved={float(solved.mean()):.3f}"
              f" edge-iters/s={lanes*im*edges/dt:.3e} "
              f"solve-depth={frac}")


if __name__ == "__main__":
    main()
