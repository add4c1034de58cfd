"""Punctured QC-LDPC BLER waterfall through the QC decoder.

Regenerates benchmarks/results/punctured_bler_r2.json: block error rate
vs Eb/N0 for a rate-3/4 QC code under BPSK/AWGN, unpunctured vs with
the first 2Z block columns punctured (never transmitted, LLR 0) — the
5G rate-matching pattern, decoded with per-bit priors via decode_soft.
"""
import sys
sys.path.insert(0, ".")
import json
import time

import jax
import numpy as np

import ldpcdecoders_tpu as lt

lt.enable_compilation_cache()

Z = 128
base = lt.random_qc_base_matrix(24, 6, 3, Z, rng=0)
dec = lt.QCMinSumDecoder(base, Z, per=0.02, max_iters=60, schedule="layered")
n = dec.n
k_eff = n - dec.m  # info bits (full-rank assumption for rate accounting)
punctured = np.zeros(n, bool)
punctured[: 2 * Z] = True
B = 2048
rng = np.random.default_rng(0)

points = {}
for snr_db in (0.5, 1.0, 1.5, 2.0, 2.5, 3.0):
    # Eb/N0 -> noise sigma for rate r BPSK: sigma^2 = 1/(2 r Eb/N0)
    row = {}
    for punct in (False, True):
        tx_frac = 1.0 - (punctured.mean() if punct else 0.0)
        r_eff = k_eff / (n * tx_frac)  # code rate over *transmitted* bits
        sigma = float(np.sqrt(1.0 / (2.0 * r_eff * 10 ** (snr_db / 10))))
        y = 1.0 + sigma * rng.standard_normal((B, n))
        llr = 2.0 * y / sigma**2
        if punct:
            llr[:, punctured] = 0.0
        t0 = time.perf_counter()
        cw, ok = lt.decode_soft(dec, llr)
        dt = time.perf_counter() - t0
        bler = float((cw.any(axis=1)).mean())
        row["punctured" if punct else "full"] = {
            "bler": bler,
            "ber": float(cw.mean()),
            "converged": float(ok.mean()),
            "sigma": sigma,
            "rate_eff": r_eff,
            "decodes_per_s": B / dt,
        }
    points[snr_db] = row
    print(snr_db, "full", row["full"]["bler"], "punct", row["punctured"]["bler"])

out = {
    "code": f"QC (nb=24, wr=6, wc=3, Z={Z}) n={n}, layered QC min-sum",
    "channel": "BPSK/AWGN, all-zero codeword",
    "puncture": "first 2Z block columns (LLR 0 at the receiver)",
    "batch": B,
    "points": {str(k): v for k, v in points.items()},
    "device": str(jax.devices()[0]),
}
json.dump(out, open("benchmarks/results/punctured_bler_r2.json", "w"), indent=1)
print("saved")
