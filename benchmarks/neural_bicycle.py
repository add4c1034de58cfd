"""Neural min-sum (+OSD) on the bivariate-bicycle "gross" code.

Regenerates benchmarks/results/neural_bicycle_r2.json.  Trains the
per-edge-weighted min-sum (models/neural.py, param_scope='edge') on the
bb144 [[144,12,12]] X stabilizer block and measures degeneracy-aware
logical failure of Z-error decoding against plain min-sum, exact
sum-product, and — the production pairing for quantum LDPC codes —
BP+OSD-0 with either the exact-BP or the trained neural inner decoder
(models/bposd.py `inner=`).  The quantum-LDPC literature's motivating
observation (e.g. Bravyi et al. 2024 decode BB codes with BP-OSD):
plain BP alone is badly trapping-set-limited on these loopy graphs,
OSD repairs syndrome consistency, and learned message weights recover
additional logical accuracy at zero decode-time cost.
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

Hx, Hz, info = lt.named_bicycle_code("bb144")
T = 30
train_per = 0.04

t0 = time.time()
neural = NeuralMinSumDecoder(Hx, train_per, T, param_scope="edge")
hist = neural.train(steps=600, batch=512, seed=0)
train_s = time.time() - t0
print(f"trained {train_s:.0f}s; loss {hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}")

in_z_span = gf2_rowspan_reducer(Hz)  # residual in rowspan(Hz) => harmless
decoders = {
    "minsum_plain": lt.MinSumDecoder(Hx, train_per, T),
    "sumproduct": lt.BeliefPropagationDecoder(Hx, train_per, T),
    "neural_edge": neural,
    "bposd0": lt.BeliefPropagationOSDDecoder(Hx, train_per, T),
    "neural_osd0": lt.BeliefPropagationOSDDecoder(Hx, train_per, T, inner=neural),
    "bposd_w4": lt.BeliefPropagationOSDDecoder(Hx, train_per, T, osd_order=4),
    "bposd_cs60": lt.BeliefPropagationOSDDecoder(
        Hx, train_per, T, osd_order=60, osd_method="combination_sweep"
    ),
    "neural_cs60": lt.BeliefPropagationOSDDecoder(
        Hx, train_per, T, osd_order=60, osd_method="combination_sweep", inner=neural
    ),
}
B = 4096
points = {}
for per in (0.02, 0.04, 0.06):
    rng = np.random.default_rng(int(per * 1e4))
    e = rng.random((B, Hx.shape[1])) < per
    syn = ((e @ Hx.T) % 2).astype(np.int8)
    row = {}
    for name, dec in decoders.items():
        out, ok = dec.batch_decode(syn, per=per)
        sh = (out.astype(np.int64) @ Hx.T) % 2
        smatch = (sh == syn).all(axis=1)
        resid = e.astype(np.uint8) ^ out.astype(np.uint8)
        logical_fail = ~in_z_span(resid) | ~smatch
        row[name] = {
            "syndrome_match": float(smatch.mean()),
            "logical_fail": float(logical_fail.mean()),
        }
        print(per, name, row[name])
    points[per] = row

out = {
    "code": "bb144 gross [[144,12,12]] (Bravyi et al. 2024), "
            "Z errors / X stabilizers",
    "decoder_iters": T,
    "train": {"per": train_per, "steps": 600, "batch": 512,
              "seconds": train_s, "params": int(neural.w.size + 2 * T)},
    "trials_per_point": B,
    "points": {str(k): v for k, v in points.items()},
    "device": str(jax.devices()[0]),
}
json.dump(out, open("benchmarks/results/neural_bicycle_r2.json", "w"), indent=1)
print("saved")
