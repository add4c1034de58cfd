#!/usr/bin/env python3
"""Drive the decode paths once on an NVIDIA GPU and check every result.

    python chip_smoke.py              # phases 0-4 on one card
    python chip_smoke.py --chips 4    # the four-card phase only

Phases (one card):
  0. device: the first JAX device must be a GPU; print its kind, the
     device count and the card's name and power limit;
  1. the reference benchmark configuration, a (1000, 10, 9) Gallager code
     (rng=42) at per=0.01, 100 iterations, batch 1024, through f32
     sum-product BP, bf16 min-sum, int8 min-sum and fused BP+OSD-2,
     checked against golden/numpy_ref.py and against the same programs
     run on the host CPU;
  2. an OSD-heavy input (per=0.2: BP fails on most lanes) through fused
     BP+OSD-2: every output syndrome-consistent, the Pallas GF(2)
     elimination kernels bit-identical to their XLA form, and the OSD-2
     candidate sweep identical to the host CPU's;
  3. a device-sampled FER sweep (harness.FERSweep, min-sum, p=0.02,
     4 x 16384 trials) against the same seed on the host CPU;
  4. the bb144 [[144,12,12]] memory-z circuit-level DEM (R=6, p=0.003)
     through StagedDemDecoder in its round-5 flagship configuration:
     4096 shots, every OSD output syndrome-consistent, at most 8 logical
     failures.

With ``--chips 4`` only the four-card phase runs: fused BP+OSD-2 at the
reference configuration (batch 8192) over a 4-card data mesh, bit for bit
against one card, and check-sharded min-sum on a (1, 4) mesh over a
~112k-qubit hypergraph-product code against unsharded min-sum.

Every phase raises on a failed check, and nothing catches it.  The last
line of standard output is one JSON object naming the device; it is
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REF = dict(n=1000, w_r=10, w_c=9, rng=42, per=0.01, max_iters=100, batch=1024)
GOLDEN_LANES = 64
FER = dict(p=0.02, max_iters=60, batch=16384, steps=4, seed=7)
FOUR = dict(batch=8192, hgp_seed_n=300, lanes=1024, weight=40)


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def require_gpu(jax):
    """Phase 0: the first device must be a GPU; returns the device dict."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this script does not run on the CPU")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed(fn, *args, reps=3):
    """(result, first-call seconds, median of ``reps`` later calls)."""
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return out, first, float(np.median(ts))


def reference_code():
    import ldpcdecoders_tpu as lt

    return lt.parity_check_matrix(REF["n"], REF["w_r"], REF["w_c"],
                                  rng=REF["rng"])


def sample(H, per, batch, seed):
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, H.shape[1])) < per).astype(np.int64)
    return errs, ((errs @ H.T.astype(np.int64)) % 2).astype(np.int8)


def syndromes_match(H, errs, syn):
    got = (np.asarray(errs).astype(np.int64) @ H.T.astype(np.int64)) % 2
    return (got == syn).all(axis=1)


def on_cpu_too(build, syn):
    """Build the decoder with the host CPU as default device and decode
    ``syn`` there: the same program, compiled for the CPU."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return build().batch_decode(syn)


def lanes_identical(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.reshape(a.shape[0], -1) == b.reshape(b.shape[0], -1)).all(axis=1)


def phase1(H):
    """Reference configuration through the four main decoder kinds."""
    import jax.numpy as jnp

    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.golden.numpy_ref import bp_decode, osd_postprocess

    per, iters, B = REF["per"], REF["max_iters"], REF["batch"]
    errs, syn = sample(H, per, B, seed=1)
    lanes = np.random.default_rng(2).choice(B, GOLDEN_LANES, replace=False)

    # f32 sum-product vs the golden run at float32: hard decisions and
    # convergence flags identical on every sampled lane (same arithmetic,
    # same dtype; only the summation order of XLA's reductions differs)
    bp = lt.DecoderConfig(kind="bp", per=per, max_iters=iters).build(H)
    (e_bp, c_bp), first, med = timed(bp.batch_decode, syn)
    log(f"phase1 bp f32: first call {first:.2f} s, median {med * 1e3:.2f} ms "
        f"(batch {B}), converged {np.mean(c_bp):.4f}")
    golden = {}
    bad = []
    for i in lanes:
        g_err, g_conv, g_lp, _ = bp_decode(H, syn[i], per, iters,
                                           dtype=np.float32)
        golden[int(i)] = (g_err, g_lp)
        if not (np.array_equal(g_err.astype(np.int8), e_bp[i])
                and bool(g_conv) == bool(c_bp[i])):
            bad.append(int(i))
    for i in bad:
        log(f"phase1 bp lane {i} differs from golden: "
            f"{int((golden[i][0].astype(np.int8) != e_bp[i]).sum())} bits")
    check(not bad, f"f32 BP differs from golden on lanes {bad}")
    log(f"phase1 bp f32 vs golden: {GOLDEN_LANES}/{GOLDEN_LANES} lanes identical")

    # bf16 and int8 min-sum vs the same program on the host CPU: >= 99% of
    # lanes identical (bf16 sums are taken in another order there)
    for name, build in (
        ("minsum bf16",
         lambda: lt.MinSumDecoder(H, per, iters, dtype=jnp.bfloat16)),
        ("minsum int8",
         lambda: lt.DecoderConfig(kind="minsum_int8", per=per,
                                  max_iters=iters).build(H)),
    ):
        dec = build()
        (e_g, c_g), first, med = timed(dec.batch_decode, syn)
        e_c, c_c = on_cpu_too(build, syn)
        same = lanes_identical(e_g, e_c) & (np.asarray(c_g) == c_c)
        log(f"phase1 {name}: first call {first:.2f} s, median "
            f"{med * 1e3:.2f} ms, converged {np.mean(c_g):.4f}, "
            f"{same.mean():.4f} of lanes identical to the CPU run")
        check(same.mean() >= 0.99, f"{name}: only {same.mean():.4f} of "
              "lanes match the CPU run (need 0.99)")

    # fused BP+OSD-2 vs golden BP + golden OSD-2 on the same lanes:
    # identical outputs (the OSD is exact GF(2) arithmetic on the same
    # reliability order)
    bposd = lt.DecoderConfig(kind="bposd", per=per, max_iters=iters,
                             fused=True, osd_order=2).build(H)
    check(bposd.osd_kernel, "the reference code must take the GF(2) kernel")
    (e_o, c_o), first, med = timed(bposd.batch_decode, syn)
    log(f"phase1 bposd osd2 fused: first call {first:.2f} s, median "
        f"{med * 1e3:.2f} ms, converged {np.mean(c_o):.4f}")
    check(syndromes_match(H, e_o, syn).all(), "BP+OSD output misses a syndrome")
    bad = [int(i) for i in lanes if not np.array_equal(
        osd_postprocess(H, syn[i], golden[int(i)][0], golden[int(i)][1], 2)
        .astype(np.int8), e_o[i])]
    check(not bad, f"BP+OSD-2 differs from golden on lanes {bad}")
    log(f"phase1 bposd osd2 vs golden: {GOLDEN_LANES}/{GOLDEN_LANES} lanes identical")


def phase2(H):
    """OSD-heavy input: consistency, and kernel vs XLA elimination."""
    import jax
    import jax.numpy as jnp

    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.models.bposd import make_fused_bposd_fn
    from ldpcdecoders_tpu.ops.gf2 import (
        gf2_eliminate,
        gf2_osd0,
        osdw_sweep,
        pack_bits,
    )
    from ldpcdecoders_tpu.ops.pallas_gf2 import (
        gf2_eliminate_pallas,
        gf2_osd0_pallas,
    )

    per, iters, B = REF["per"], REF["max_iters"], REF["batch"]
    m, n = H.shape
    _, syn = sample(H, 0.2, B, seed=3)
    dec = lt.DecoderConfig(kind="bposd", per=per, max_iters=iters,
                           fused=True, osd_order=2).build(H)
    _, first, med = timed(dec.batch_decode, syn)
    e, c, _, aux, _ = dec.batch_decode_detailed(syn)
    reached = 1.0 - float(np.mean(c))
    log(f"phase2 bposd osd2 at per=0.2: first call {first:.2f} s, median "
        f"{med * 1e3:.2f} ms, {reached:.4f} of lanes reach OSD")
    check(reached >= 0.5, f"only {reached:.4f} of lanes reached OSD")
    check(syndromes_match(H, e, syn).all(), "OSD output misses a syndrome")

    # the decision for the kernel: the whole fused BP+OSD-2 program with
    # the kernel and with the XLA elimination, same inputs, same card
    syn_d = jnp.asarray(syn)
    outs = {}
    for kernel in (True, False):
        fn = jax.jit(make_fused_bposd_fn(dec.graph, per, iters, 2,
                                         kernel=kernel))
        outs[kernel], first, med = timed(fn, syn_d)
        log(f"phase2 fused bp+osd2 elimination={'kernel' if kernel else 'xla'}:"
            f" first call {first:.2f} s, median {med * 1e3:.2f} ms")
    check(np.array_equal(np.asarray(outs[True][0]), np.asarray(outs[False][0])),
          "fused BP+OSD-2 differs between the kernel and the XLA form")

    # the kernels alone, bit for bit, on this phase's lanes in the
    # decoder's own reliability order
    logp = np.asarray(aux["log_probabs"], np.float32)
    with np.errstate(over="ignore"):
        probs = np.exp(logp)
    order = np.argsort(-np.maximum(probs, 1.0 - probs), axis=1, kind="stable")
    Hs = np.take(H.astype(np.uint32), order, axis=1).transpose(1, 0, 2)
    Hp = jax.vmap(pack_bits)(jnp.asarray(Hs))
    Ht = jnp.transpose(Hp, (0, 2, 1))
    s_u = jnp.asarray(syn.astype(np.uint32))
    ref = jax.jit(jax.vmap(lambda h, v: gf2_eliminate(h, v, n)[:3]))(Ht, s_u)
    got = jax.jit(lambda h, v: gf2_eliminate_pallas(h, v, n))(Ht, s_u)
    for name, a, b in zip(("matrix", "syndrome", "pivots"), ref, got):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"GF(2) elimination kernel: {name} differs from XLA")
    # OSD-0 from BP's hard decisions (log-probability ratio <= 0): their
    # residual syndromes are non-zero on every BP-failing lane
    bp_hard = (logp <= 0).astype(np.int64)
    bp_s = jnp.asarray(np.take_along_axis(bp_hard, order, axis=1)
                       .astype(np.uint32))
    resid = jnp.asarray((syn.astype(np.int64) ^ syndromes_bits(H, bp_hard))
                        .astype(np.uint32))
    ref0 = jax.jit(jax.vmap(lambda h, b, r: gf2_osd0(h, b, r, n)))(Hp, bp_s, resid)
    got0 = jax.jit(lambda h, r, b: gf2_osd0_pallas(h, r, b, n))(Ht, resid, bp_s)
    check(np.array_equal(np.asarray(ref0), np.asarray(got0)),
          "GF(2) OSD-0 kernel differs from XLA")
    # the OSD-2 candidate sweep on these eliminated systems, on the GPU
    # and on the host CPU: its s8 x s8 -> s32 dots (cuBLASLt or XLA's
    # fallback) must give the CPU's results exactly.  (Whole decodes are
    # not compared across platforms here: after 100 non-converging BP
    # iterations the soft outputs, and so the OSD column order, depend
    # on float summation order.)
    rank = jnp.sum((got[2] != n).astype(jnp.int32), axis=1)
    sweep = jax.jit(jax.vmap(
        lambda h, v, p, r, b: osdw_sweep(h, v, p, r, b, 2, n)))
    sweep_args = (*got, rank, bp_s)
    on_gpu = np.asarray(sweep(*sweep_args))
    cpu = jax.devices("cpu")[0]
    on_cpu = np.asarray(sweep(*(jax.device_put(x, cpu) for x in sweep_args)))
    check(np.array_equal(on_gpu, on_cpu), "OSD-2 sweep differs from the CPU")
    log(f"phase2 kernels vs XLA on {B} lanes: pivots, transformed syndromes "
        "and OSD-0 corrections identical; OSD-2 sweep identical to the CPU")


def syndromes_bits(H, errs):
    return (errs.astype(np.int64) @ H.T.astype(np.int64)) % 2


def phase3(H):
    """Device-sampled FER sweep vs the same seed on the host CPU."""
    import jax

    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.harness import FERSweep

    p, batch, steps = FER["p"], FER["batch"], FER["steps"]

    def run():
        sweep = FERSweep(H, lambda q: lt.MinSumDecoder(H, q, FER["max_iters"]),
                         [p], batch=batch, seed=FER["seed"], pipeline=4,
                         sample_on_device=True)
        t = time.perf_counter()
        sweep.run(trials_per_point=steps * batch)
        return sweep.points[p], time.perf_counter() - t

    gpu, wall = run()
    log(f"phase3 FERSweep minsum p={p}: {gpu.trials} trials in {wall:.2f} s "
        f"(compile included), {gpu.exact_failures} failures, "
        f"{gpu.syndrome_mismatches} syndrome mismatches")
    with jax.default_device(jax.devices("cpu")[0]):
        cpu, wall = run()
    log(f"phase3 same seed on the CPU: {cpu.exact_failures} failures "
        f"({wall:.2f} s)")
    check(gpu.trials == cpu.trials == steps * batch, "trial counts differ")
    # the samples are the same bits on both platforms; only float
    # summation order differs, so the counts agree to 0.5% of trials
    diff = abs(gpu.exact_failures - cpu.exact_failures)
    check(diff <= 0.005 * gpu.trials,
          f"failure counts differ by {diff} (> 0.5% of {gpu.trials})")


def phase4():
    """bb144 circuit-level DEM through the staged production decoder."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ldpcdecoders_tpu.models.staged import StagedDemDecoder

    z = np.load(os.path.join(ROOT, "benchmarks", "results",
                             "bb144_r6_p0.003.npz"))
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                      shape=tuple(z["shape"]))
    check(A.shape == (864, 31_648), f"unexpected DEM shape {A.shape}")
    # the round-5 flagship (benchmarks/circuit_level_bb144_r5.py defaults)
    dmem = (-0.24, 0.66)
    dec = StagedDemDecoder(
        A, z["priors"], observables=z["obs"], gammas=(0.4,) + (dmem,) * 5,
        stage0_iters=96, deep_iters=500, lam=60, lam3=40, check_every=8,
        relay_legs=8, layout="check", dtype=jnp.float32,
        deep_dtype=jnp.bfloat16)
    kw = dict(batch=1024, deep_bucket=256, pipeline=3)
    t = time.perf_counter()
    dec.run_eval(1024, seed=5, **kw)
    log(f"phase4 staged bb144: warm-up (compilation) {time.perf_counter() - t:.2f} s")
    st = dec.run_eval(4096, seed=11, **kw)
    prof = st["profile"]
    log(f"phase4 staged bb144: {st['shots']} shots, {st['fails']} logical "
        f"failures, {st['throughput_shots_per_s']:.1f} shots/s, "
        f"OSD {prof['osd_consistent']}/{prof['osd_shots']} consistent, "
        f"wall {prof['wall_s']:.2f} s")
    check(st["shots"] == 4096, f"ran {st['shots']} shots")
    check(prof["osd_consistent"] == prof["osd_shots"],
          "an OSD output misses its syndrome")
    # 37/98,304 recorded (circuit_level_bb144_r5.json): 1.5 expected in
    # 4096 shots; 9 or more has a Poisson tail under 1e-4
    check(st["fails"] <= 8, f"{st['fails']} logical failures (> 8)")


def phase_four_cards():
    """Data-parallel BP+OSD and check-sharded min-sum on four cards."""
    import jax
    import scipy.sparse as sp

    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.codes import hypergraph_product_edges
    from ldpcdecoders_tpu.parallel import (
        make_check_sharded_minsum_fn,
        make_mesh,
        sharded_batch_decode,
    )

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices (need 4)")
    H = reference_code()
    _, syn = sample(H, REF["per"], FOUR["batch"], seed=13)
    dec = lt.DecoderConfig(kind="bposd", per=REF["per"],
                           max_iters=REF["max_iters"], fused=True,
                           osd_order=2).build(H)
    t = time.perf_counter()
    e1, c1 = dec.batch_decode(syn)
    log(f"4cards bposd osd2 batch {FOUR['batch']} on one card: "
        f"{time.perf_counter() - t:.2f} s (compile included)")
    mesh = make_mesh(4, axis_names=("data",))
    sharded_batch_decode(dec, syn, mesh)  # compile
    t = time.perf_counter()
    e4, c4 = sharded_batch_decode(dec, syn, mesh)
    log(f"4cards bposd osd2 batch {FOUR['batch']} over a 4-card data mesh: "
        f"{time.perf_counter() - t:.2f} s")
    check(np.array_equal(e1, e4) and np.array_equal(c1, c4),
          "data-parallel BP+OSD differs from one card")
    log(f"4cards bposd: {FOUR['batch']}/{FOUR['batch']} lanes identical to one card")

    # examples/tensor_parallel_hgp.py's code: HGP of a (300, 6, 3) code
    H1 = lt.parity_check_matrix(FOUR["hgp_seed_n"], 6, 3, rng=7)
    rows, cols, m, n = hypergraph_product_edges(H1, H1)[0]
    graph = lt.TannerGraph.from_edges(rows, cols, m, n)
    Hx = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(m, n))
    rng = np.random.default_rng(17)
    B = FOUR["lanes"]
    errs = np.zeros((B, n), np.int8)
    for b in range(B):
        errs[b, rng.choice(n, size=FOUR["weight"], replace=False)] = 1
    syn = np.asarray((Hx @ errs.T).T % 2, np.int8)
    one = lt.MinSumDecoder(graph, 0.001, 30)
    e1, c1 = one.batch_decode(syn)
    mesh2 = make_mesh(4, axis_names=("data", "model"), shape=(1, 4))
    fn = make_check_sharded_minsum_fn(graph, 0.001, 30, mesh2)
    t = time.perf_counter()
    e4, c4, _ = (np.asarray(x) for x in fn(syn))
    log(f"4cards check-sharded minsum on {n} qubits x {m} checks: "
        f"{time.perf_counter() - t:.2f} s (compile included)")
    same = lanes_identical(e1, e4) & (c1 == c4)
    for i in np.flatnonzero(~same):
        log(f"4cards check-sharded lane {i}: converged {bool(c1[i])} on one "
            f"card, {bool(c4[i])} sharded, "
            f"{int((e1[i] != e4[i]).sum())} bits differ")
    log(f"4cards check-sharded minsum: {same.mean():.4f} of lanes identical "
        f"to one card, converged {c4.mean():.4f}")
    # the psum adds per-shard partial sums in another order: >= 99.9%
    check(same.mean() >= 0.999, f"only {same.mean():.4f} of lanes match")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    device = require_gpu(jax)
    log(f"device: {device['kind']} x {device['count']} ({device['platform']})")
    log(f"nvidia-smi: {card_name_and_power()}")
    sys.path.insert(0, ROOT)
    if args.chips == 4:
        phase_four_cards()
    else:
        H = reference_code()
        for phase in (phase1, phase2, phase3):
            t = time.perf_counter()
            phase(H)
            log(f"{phase.__name__} passed in {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase4()
        log(f"phase4 passed in {time.perf_counter() - t:.2f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
