"""Erasure-threshold sweep: peeling vs ML curves on a (2400, 6, 3) code.

Regenerates benchmarks/results/erasure_threshold_r2.json.
Theory: (3,6)-regular BEC peeling threshold 0.4294, ML 0.4882.
"""
import sys
sys.path.insert(0, ".")
import json
import numpy as np, jax
import ldpcdecoders_tpu as lt
lt.enable_compilation_cache()
H = lt.parity_check_matrix(2400, 6, 3, rng=0)
n = H.shape[1]
dec_ml = lt.ErasurePeelingDecoder(H)            # gf2 completion = ML
dec_pl = lt.ErasurePeelingDecoder(H, on_stuck="fail")
B = 2048
rng = np.random.default_rng(0)
points = {}
for rate in (0.30, 0.35, 0.40, 0.42, 0.44, 0.46, 0.48, 0.50):
    eps = rng.random((B, n)) < rate
    e = eps & (rng.random((B, n)) < 0.5)
    syn = ((e @ H.T) % 2).astype(np.int8)
    _, ok_pl = dec_pl.batch_decode(syn, eps)
    err_ml, ok_ml = dec_ml.batch_decode(syn, eps)
    exact_ml = (err_ml == e).all(axis=1)
    points[rate] = {
        "peeling_success": float(ok_pl.mean()),
        "ml_solvable": float(ok_ml.mean()),
        "ml_exact": float(exact_ml.mean()),
        "trials": B,
    }
    print(rate, points[rate])
out = {
    "code": "(2400, wr=6, wc=3) Gallager",
    "theory": {"peeling_threshold_36_regular": 0.4294,
               "ml_threshold_36_regular": 0.4882,
               "capacity_rate_half": 0.5},
    "points": points,
    "device": str(jax.devices()[0]),
}
json.dump(out, open("benchmarks/results/erasure_threshold_r2.json", "w"), indent=1)
print("saved")
