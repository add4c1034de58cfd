"""The circuit-level production path: staged ensembles + relay + OSD.

Builds the bb144 (or, by default here, a fast surface-code) memory
experiment, extracts its exact DEM, and evaluates the staged production
decoder: stage-0 damped min-sum on every shot, a device-fused
disordered-memory ensemble on stragglers, relay restarts with fresh
draws on survivors, and the native full-RREF OSD-CS on whatever is
left.  Prints the logical error rate with the stage-by-stage profile
(where the shots went, where the failures came from).

Recorded on bb144 R=6 (benchmarks/results/circuit_level_bb144_r4.json):
per-round LER 2.1e-5 at p=0.001 (163,840 shots) — 18x below the round-3
single-decoder curve on the same machinery lineage.

Run:  python examples/staged_production_decoding.py [--bb144]
"""

import json
import sys

import ldpcdecoders_tpu as lt

bb144 = "--bb144" in sys.argv
p, rounds = 0.003, 3
if bb144:
    Hx, Hz, *_ = lt.named_bicycle_code("bb144")
    rounds = 6
else:
    Hx, Hz = lt.surface_code_x(3), lt.surface_code_z(3)

circ = lt.css_memory_circuit(Hx, Hz, rounds, p=p)
A, priors, O = lt.circuit_dem(circ)
print(f"DEM: {A.shape[0]} detectors x {A.shape[1]} mechanisms")

dm = (-0.24, 0.66)  # disordered-memory draw range (Relay-BP style)
dec = lt.StagedDemDecoder(
    A, priors, observables=O,
    gammas=(0.4,) + (dm,) * 2,     # 1 uniform + 2 disordered members
    stage0_iters=48, deep_iters=500,
    lam=40, lam3=20, relay_legs=2)

stats = dec.run_eval(8192, batch=2048, deep_bucket=128)
prof = stats.pop("profile")
print(json.dumps(stats, indent=2))
print(f"stage0 solved {prof['stage0_conv']:.1%}; "
      f"{prof['deep_shots']} shots went deep ({prof['deep_solved']} solved "
      f"by the ensemble+relay), {prof['osd_shots']} to host OSD; "
      f"failures by stage: {prof['fails_by_stage']}")
