"""Neural per-edge BP on the toric code: logical error rates.

Regenerates benchmarks/results/neural_toric_r2.json.  Trains
per-edge-weighted min-sum (models/neural.py, param_scope='edge') on the
toric d=6 X stabilizer block and measures degeneracy-aware logical
failure rates of Z-error decoding against plain min-sum and exact
sum-product — the Liu-Poulin neural-BP effect: learned weights break
trapping-set symmetries that defeat uniform BP on loopy quantum graphs.
"""
import sys
sys.path.insert(0, ".")
import json
import time

import jax
import numpy as np

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.models.neural import NeuralMinSumDecoder
from ldpcdecoders_tpu.utils import gf2_rowspan_reducer

lt.enable_compilation_cache()

d = 6
Hx, Hz = lt.toric_code_x(d), lt.toric_code_z(d)
T = 12
train_per = 0.04

t0 = time.time()
neural = NeuralMinSumDecoder(Hx, train_per, T, param_scope="edge")
hist = neural.train(steps=400, batch=512, seed=0)
train_s = time.time() - t0
print(f"trained {train_s:.0f}s; loss {hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}")

in_z_span = gf2_rowspan_reducer(Hz)  # residual in rowspan(Hz) => harmless
decoders = {
    "minsum_plain": lt.MinSumDecoder(Hx, train_per, T),
    "minsum_a0.8": lt.MinSumDecoder(Hx, train_per, T, alpha=0.8),
    "neural_edge": neural,
    "sumproduct": lt.BeliefPropagationDecoder(Hx, train_per, T),
}
B = 4096
points = {}
for per in (0.02, 0.03, 0.04):
    rng = np.random.default_rng(int(per * 1e4))
    e = rng.random((B, Hx.shape[1])) < per
    syn = ((e @ Hx.T) % 2).astype(np.int8)
    row = {}
    for name, dec in decoders.items():
        out, ok = dec.batch_decode(syn, per=per)
        sh = (out.astype(np.int64) @ Hx.T) % 2
        smatch = (sh == syn).all(axis=1)
        resid = (e.astype(np.uint8) ^ out.astype(np.uint8))
        logical_fail = ~in_z_span(resid) | ~smatch
        row[name] = {
            "syndrome_match": float(smatch.mean()),
            "logical_fail": float(logical_fail.mean()),
        }
        print(per, name, row[name])
    points[per] = row

out = {
    "code": f"toric d={d} (n={Hx.shape[1]}), Z errors / X stabilizers",
    "decoder_iters": T,
    "train": {"per": train_per, "steps": 400, "batch": 512,
              "seconds": train_s, "params": int(neural.w.size + 2 * T)},
    "trials_per_point": B,
    "points": {str(k): v for k, v in points.items()},
    "device": str(jax.devices()[0]),
}
json.dump(out, open("benchmarks/results/neural_toric_r2.json", "w"), indent=1)
print("saved")
