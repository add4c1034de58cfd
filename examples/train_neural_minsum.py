"""Train a neural min-sum schedule and compare FER against baselines.

Run:  python examples/train_neural_minsum.py
"""

import numpy as np

import ldpcdecoders_tpu as lt

H = lt.parity_check_matrix(1000, 10, 9, rng=42)   # reference benchmark code
per, T = 0.035, 10                                # few iterations: min-sum hurts

dec = lt.NeuralMinSumDecoder(H, per, T)
hist = dec.train(steps=200, batch=512, seed=0)
print(f"loss {hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}")
print("alpha schedule:", np.round(dec.alpha, 3))
print("beta schedule: ", np.round(dec.beta, 3))

rng = np.random.default_rng(7)
errors = rng.random((4096, 1000)) < per
syndromes = (errors @ H.T) % 2

for name, d in {
    "plain min-sum    ": lt.MinSumDecoder(H, per, T),
    "hand-tuned a=0.8 ": lt.MinSumDecoder(H, per, T, alpha=0.8),
    "trained schedule ": dec,
    "exact sum-product": lt.BeliefPropagationDecoder(H, per, T),
}.items():
    out, ok = d.batch_decode(syndromes)
    fer = 1 - (out.astype(bool) == errors).all(axis=1).mean()
    print(f"{name}: FER {fer:.4%}  converged {ok.mean():.1%}")
