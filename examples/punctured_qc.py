"""Punctured QC-LDPC decoding through the QC decoder (5G-style).

Production QC codes puncture columns at transmission (5G NR never sends
the first 2Z systematic bits); the receiver simply has no channel
information there.  With the decoder's per-bit prior input, punctured
positions decode as LLR 0 — no special casing, one compiled program.

Run:  python examples/punctured_qc.py
"""

import numpy as np

import ldpcdecoders_tpu as lt

Z = 128
base = lt.random_qc_base_matrix(24, 6, 3, Z, rng=0)   # rate-3/4 QC code
dec = lt.QCMinSumDecoder(base, Z, per=0.02, max_iters=60,
                         schedule="layered")
n = dec.n
punctured = np.zeros(n, bool)
punctured[: 2 * Z] = True                             # never transmitted

rng = np.random.default_rng(0)
B = 512
sigma = 10 ** (-3.0 / 20)                             # 3 dB Eb/N0-ish
tx = np.ones((B, n))                                  # all-zero codeword, BPSK
rx_llr = 2.0 * (tx + sigma * rng.standard_normal((B, n))) / sigma**2
rx_llr[:, punctured] = 0.0                            # no channel info

codeword, ok = lt.decode_soft(dec, rx_llr)
ber = codeword.mean()
raw = (rx_llr[:, ~punctured] < 0).mean()
print(f"punctured {punctured.sum()}/{n} bits; raw channel BER {raw:.4f}")
print(f"decoded BER {ber:.2e}, converged {ok.mean():.1%} "
      f"(punctured bits recovered from parity structure alone)")
