"""Sliding-window streaming decode: rounds/s and per-commit latency.

VERDICT r2 item 5: the real-time decoder's selling point was never
measured.  Round 3 made `SlidingWindowDecoder.decode_stream` a device
chain (carry/E/conv stay on device; windows enqueue without a host
sync; one fetch at the end), bit-identical to the host loop (tested).
This benchmark measures, on the accelerator:

  * **bulk streaming throughput** — B parallel streams of R rounds,
    rounds/s = B*R / wall on the second (warm) call;
  * **single-stream commit latency** — B=1, one mid-stream window
    dispatched and synced: the time from "window data ready" to
    "committed correction on host", i.e. the real-time figure of merit
    (C rounds are committed per window, so latency/C is per-round).

Cases: toric d=3/d=5 and bb144 detector streams at p=q=0.01, window=3
commit=1 (the standard overlap).

Usage: python benchmarks/streaming.py [--out FILE] [--quick]
"""

import argparse
import json
import os
import time

import numpy as np

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.codes.spacetime import detectors_of
from ldpcdecoders_tpu.models.window import SlidingWindowDecoder
from ldpcdecoders_tpu.utils.noise import sample_errors, syndromes_of


def make_stream(H, B, R, p, q, seed):
    rng = np.random.default_rng(seed)
    m, n = np.asarray(H).shape
    e = sample_errors(rng, B * R, n, p).reshape(B, R, n)
    cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
    syn = np.stack([syndromes_of(H, cum[:, r]) for r in range(R)], axis=1)
    u = sample_errors(rng, B * R, m, q).reshape(B, R, m)
    u[:, -1] = 0
    syn ^= u.astype(np.uint8)
    return detectors_of(syn).reshape(B, R, m)


def run_case(name, H, B, R, p, results, *, max_iters=40, window=3, commit=1):
    import jax

    win = SlidingWindowDecoder(H, p, max_iters=max_iters, window=window,
                               commit=commit)
    det = make_stream(H, B, R, p, p, seed=5)
    E, info = win.decode_detector_stream(det, seed=1)  # compile
    t0 = time.perf_counter()
    E, info = win.decode_detector_stream(det, seed=1)
    bulk = time.perf_counter() - t0
    # bit-identical host cross-check on a slice (cheap insurance)
    Eh, _ = win._decode_stream_host(det[:8].astype(np.uint8), 1)
    assert (E[:8] == Eh).all(), "device/host stream mismatch"

    # single-stream commit latency: one mid-window device step, synced
    d1 = det[:1]
    if win._mid_step is None:  # warm the B=1 program
        pass
    win.decode_detector_stream(d1, seed=2)
    import jax.numpy as jnp

    carry = jnp.zeros((1, win.m), jnp.int32)
    E1 = jnp.zeros((1, win.n), jnp.int32)
    conv = jnp.float32(0.0)
    step = win._mid_step
    # warm
    r = step(d1[:, :window], carry, E1, conv, 3)
    jax.block_until_ready(r)
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        r = step(d1[:, :window], carry, E1, conv, 3 + i)
        jax.block_until_ready(r)
        lat.append(time.perf_counter() - t0)
    lat_ms = float(np.median(lat) * 1e3)
    results[name] = {
        "streams": B, "rounds": R, "per": p,
        "window": window, "commit": commit,
        "windows": info["windows"], "converged": info["converged"],
        "bulk_wall_seconds": bulk,
        "rounds_per_s": B * R / bulk,
        "commit_latency_ms": lat_ms,
        "latency_per_round_ms": lat_ms / commit,
    }
    print(f"{name}: {B * R / bulk:,.0f} rounds/s bulk (B={B}, R={R}); "
          f"single-stream commit latency {lat_ms:.2f} ms "
          f"({lat_ms / commit:.2f} ms/round)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    here = os.path.dirname(__file__)
    ap.add_argument("--out", default=os.path.join(
        here, "results", "streaming_r3.json"))
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    B, R = (64, 12) if a.quick else (1024, 64)

    import jax

    results = {"device": str(jax.devices()[0])}
    run_case("toric_d3", lt.toric_code_x(3), B, R, 0.01, results)
    run_case("toric_d5", lt.toric_code_x(5), B // 2, R, 0.01, results)
    Hx, *_ = lt.named_bicycle_code("bb144")
    run_case("bb144", Hx, B // 4, R, 0.003, results)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", a.out)


if __name__ == "__main__":
    main()
