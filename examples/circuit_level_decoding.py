"""Circuit-level decoding, end to end, with no external dependencies.

Builds the rotated-surface-code memory experiment as an explicit
syndrome-extraction circuit, extracts its EXACT detector error model by
fault propagation, decodes shots drawn from the circuit itself on the device,
and reports the logical error per round — the full sinter-style loop
(sample -> decode -> compare observables) in ~30 lines.

Run:  python examples/circuit_level_decoding.py
"""

import numpy as np

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.harness import dem_logical_sweep

d, rounds, p = 3, 3, 0.003

# 1. the memory-z experiment under uniform circuit-level depolarizing
#    noise (stim's generated-circuit recipe, for ANY CSS pair)
Hx, Hz = lt.surface_code_x(d), lt.surface_code_z(d)
circ = lt.css_memory_circuit(Hx, Hz, rounds, p=p)
print(f"surface d={d}, {rounds} rounds: {circ.n_qubits} qubits, "
      f"{len(circ.detectors)} detectors, {len(circ.observables)} observable")

# 2. its exact DEM (tableau-verified fault propagation); dem_text(circ)
#    writes the same model as a flattened stim-format file
A, priors, O = lt.circuit_dem(circ)
print(f"DEM: {A.shape[1]} mechanisms, priors in "
      f"[{priors.min():.2e}, {priors.max():.2e}]")

# 3. evaluate: shots sampled from the DEM priors, fully device-resident
out = dem_logical_sweep((A, priors, O), shots=20_000, rounds=rounds,
                        batch=2048, seed=7)
print(f"DEM-sampled:     LER/shot {out['logical_rate']:.4g}  "
      f"LER/round {out['per_round_rate']:.4g}  "
      f"({out['throughput_shots_per_s']:.0f} shots/s)")

# 4. cross-check with shots drawn from the CIRCUIT (Pauli-frame
#    sampling) — model-independent, must agree statistically
chk = dem_logical_sweep((A, priors, O), shots=4_096, rounds=rounds,
                        circuit=circ, seed=8)
print(f"circuit-sampled: LER/shot {chk['logical_rate']:.4g}  "
      f"(agrees within CI: "
      f"{out['logical_ci95'][0]/2 <= chk['logical_rate'] <= out['logical_ci95'][1]*2})")

# 5. the same model decodes through the uniform Decoder contract too
dec = lt.DetectorGraphDecoder(A, priors, max_iters=60, observables=O)
det, obs = lt.sample_circuit(circ, 512, seed=9)
pred, conv = dec.predict_observables(det, seed=1)
print(f"predict_observables: {np.mean((pred == obs).all(axis=1)):.3f} "
      f"correct, {conv.mean():.3f} BP-converged")
