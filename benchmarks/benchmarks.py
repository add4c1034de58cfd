"""Benchmark suite mirroring the reference's BenchmarkTools cases
(/root/reference/benchmark/benchmarks.jl): the (1000, 10, 9) Gallager
code, per=0.01, max_iters=100, decoders bposd(order 0|2), bp, bitflip,
bpots — plus this package's min-sum variants.

Reports, per case, single-syndrome latency (the reference's metric) and
batched throughput (this package's metric).  Prints one JSON object.

Usage:  python benchmarks/benchmarks.py [--batch 1024] [--profile DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run(batch: int = 1024, profile_dir: str | None = None):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    import ldpcdecoders_tpu as lt

    lt.enable_compilation_cache()
    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    per, max_iters = 0.01, 100
    rng = np.random.default_rng(0)
    errs1 = rng.random((1, H.shape[1])) < per
    syn1 = (errs1 @ H.T) % 2
    errsB = rng.random((batch, H.shape[1])) < per
    synB = (errsB @ H.T) % 2

    cases = {
        "bposd/decode_osd0": lt.BeliefPropagationOSDDecoder(H, per, max_iters),
        "bposd/decode_osd2": lt.BeliefPropagationOSDDecoder(H, per, max_iters, osd_order=2),
        "bposd/decode_osd0_fused": lt.BeliefPropagationOSDDecoder(
            H, per, max_iters, fused=True
        ),
        "bp/decode": lt.BeliefPropagationDecoder(H, per, max_iters),
        "bitflip/decode": lt.BitFlipDecoder(H, per, max_iters),
        "bpots/decode": lt.BPOTSDecoder(H, per, max_iters, T=9, C=2.0),
        "minsum/decode": lt.MinSumDecoder(H, per, max_iters),
        "minsum_int8/decode": lt.QuantizedMinSumDecoder(H, per, max_iters),
    }

    results = {}
    ctx = (
        jax.profiler.trace(profile_dir)
        if profile_dir
        else __import__("contextlib").nullcontext()
    )
    with ctx:
        for name, dec in cases.items():
            dec.batch_decode(syn1)  # compile B=1
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                dec.batch_decode(syn1)
            lat_ms = (time.perf_counter() - t0) / reps * 1e3

            dec.batch_decode(synB)  # compile B=batch
            best = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                _, conv = dec.batch_decode(synB)
                best = max(best, batch / (time.perf_counter() - t0))
            # pipelined: K batches in flight before the host sync — the
            # per-call dispatch latency otherwise floors every fast
            # decoder at the same number
            K = 4
            t0 = time.perf_counter()
            outs = [dec._decode_batch(jnp.asarray(synB)) for _ in range(K)]
            jax.block_until_ready(outs[-1][0])
            piped = K * batch / (time.perf_counter() - t0)
            results[name] = {
                "single_decode_ms": round(lat_ms, 3),
                "batched_syndromes_per_s": round(best, 1),
                "pipelined_syndromes_per_s": round(piped, 1),
                "converged_fraction": float(np.mean(conv)),
            }
            print(
                f"{name}: {lat_ms:.2f} ms/decode, {best:.0f} syndromes/s "
                f"({piped:.0f} pipelined)",
                file=sys.stderr,
            )

    out = {"config": {"code": "(1000,10,9)", "per": per, "max_iters": max_iters, "batch": batch},
           "cases": results, "device": str(jax.devices()[0])}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--profile", type=str, default=None,
                    help="directory for a jax.profiler trace (Perfetto)")
    a = ap.parse_args()
    run(a.batch, a.profile)
