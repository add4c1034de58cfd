"""Mixed erasure+flip channel sweep on a (2400, 6, 3) code.

Regenerates benchmarks/results/mixed_channel_r2.json: failure curves
over erasure rate at two flip rates via harness.mixed_fer_sweep, plus
the peel-only fast-path throughput (erasure-dominated regime, BP branch
never taken) vs the BP-engaged regime.
"""
import sys
sys.path.insert(0, ".")
import json
import time

import jax
import numpy as np

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.harness import mixed_fer_sweep
from ldpcdecoders_tpu.utils import sample_mixed_channel, syndromes_of

lt.enable_compilation_cache()

H = lt.parity_check_matrix(2400, 6, 3, rng=0)
n = H.shape[1]
rates = [0.02, 0.05, 0.10, 0.20, 0.30, 0.38]
curves = {}
for p_flip in (0.002, 0.01):
    res = mixed_fer_sweep(H, p_flip, rates, trials_per_point=2048,
                          batch=256, seed=0, osd_order=0)
    curves[str(p_flip)] = {str(k): v for k, v in res.items()}
    for eps, r in res.items():
        print(p_flip, eps, round(r["exact_failure_rate"], 4),
              "bp_steps", r["bp_engaged_steps"], "/", r["steps"],
              "peel_depth", round(r["mean_peel_rounds"], 1))

# throughput: peel-only fast path (pure erasure batch, 5% — peels clean)
# vs the same decoder with flips forcing the BP stage (no OSD here so the
# big batch fits; the OSD-bearing numbers above use batch=256)
dec = lt.MixedChannelDecoder(H, 0.01, 60)
B = 4096
rng = np.random.default_rng(1)


def timed(eps_rate, flip):
    eps, e = sample_mixed_channel(rng, B, n, flip, eps_rate)
    syn = syndromes_of(H, e)
    out = dec.batch_decode_detailed(syn, eps)  # compile / warm
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = dec.batch_decode_detailed(syn, eps)
    dt = (time.perf_counter() - t0) / reps
    return B / dt, int(out[3])


peel_rate, peel_bp = timed(0.05, 0.0)
full_rate, full_bp = timed(0.10, 0.01)
print("peel-only:", round(peel_rate), "dec/s (bp_iters", peel_bp, ")")
print("bp-engaged:", round(full_rate), "dec/s (bp_iters", full_bp, ")")

out = {
    "code": "(2400, wr=6, wc=3) Gallager",
    "decoder": "MixedChannelDecoder(minsum, peel+bp, osd_order=0, max_iters=60)",
    "curves_by_p_flip": curves,
    "throughput": {
        "batch": B,
        "peel_only_decodes_per_s": peel_rate,
        "peel_only_bp_iters": peel_bp,
        "bp_engaged_decodes_per_s": full_rate,
        "bp_engaged_bp_iters": full_bp,
    },
    "device": str(jax.devices()[0]),
}
json.dump(out, open("benchmarks/results/mixed_channel_r2.json", "w"), indent=1)
print("saved")
