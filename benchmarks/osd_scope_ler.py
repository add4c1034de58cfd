"""Does osd_scope="failed" change the LOGICAL error rate? (VERDICT r2 #8)

Reference semantics run OSD post-processing on EVERY lane
(belief_propagation_osd.jl); `osd_scope="failed"` keeps BP's own
syndrome-consistent solution on converged lanes and routes only the
failing lanes through the elimination — a large throughput win
(a round-2 throughput record) that the default quantum pipeline doesn't take
because its accuracy cost was never measured.

This script measures it PAIRED: identical detector records decoded
under both scopes, so every disagreement is attributable to the scope
choice alone (far more sensitive than comparing two independent rates).
A verdict can differ only on BP-CONVERGED lanes where OSD-0's
information-set completion lands in a different logical class than
BP's fixed point.

Cases: toric d=3, R=3 space-time at p=q=0.02 (the realistic-noise
regime where convergence is ~0.9) and bb144 R=6 at p=q=0.005.

Usage: python benchmarks/osd_scope_ler.py [--out FILE] [--quick]
"""

import argparse
import json
import os
import time

import numpy as np

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.codes.spacetime import detectors_of
from ldpcdecoders_tpu.models.spacetime import SpaceTimeDecoder
from ldpcdecoders_tpu.utils.metrics import gf2_rowspan_reducer
from ldpcdecoders_tpu.utils.noise import sample_errors, syndromes_of


def run_case(name, Hx, Hz, R, p, shots, batch, max_iters, seed, results,
             osd_order=0):
    out = {"per": p, "rounds": R, "shots": shots, "osd_order": osd_order}
    for block, (H_det, H_stab) in (("z", (Hx, Hz)), ("x", (Hz, Hx))):
        span = gf2_rowspan_reducer(H_stab)
        n = np.asarray(H_det).shape[1]
        decs = {
            scope: SpaceTimeDecoder(H_det, R, p, max_iters, decoder="bposd",
                                    osd_scope=scope, osd_order=osd_order)
            for scope in ("all", "failed")
        }
        fails = {s: 0 for s in decs}
        times = {s: 0.0 for s in decs}
        disagree = verdict_disagree = conv_tot = 0
        rng = np.random.default_rng(seed)
        done = 0
        while done < shots:
            b = min(batch, shots - done)
            e = sample_errors(rng, b * R, n, p).reshape(b, R, n)
            cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
            syn = np.stack([syndromes_of(H_det, cum[:, r]) for r in range(R)],
                           axis=1)
            u = sample_errors(rng, b * R, decs["all"].block_m, p).reshape(
                b, R, decs["all"].block_m)
            u[:, -1] = 0
            det = detectors_of(syn ^ u.astype(np.uint8))
            outs = {}
            for scope, dec in decs.items():
                t0 = time.perf_counter()
                e_hat, conv = dec.batch_decode(det, seed=seed + 1)
                times[scope] += time.perf_counter() - t0
                resid = cum[:, -1] ^ e_hat.astype(np.uint8)
                fail = ~span(resid)
                outs[scope] = (e_hat, fail)
                fails[scope] += int(fail.sum())
                if scope == "all":
                    conv_tot += int(np.asarray(conv).sum())
            disagree += int(
                (outs["all"][0] != outs["failed"][0]).any(axis=1).sum())
            verdict_disagree += int(
                (outs["all"][1] != outs["failed"][1]).sum())
            done += b
        out[block] = {
            "fails_all": fails["all"],
            "fails_failed_scope": fails["failed"],
            "corrections_differ": disagree,
            "logical_verdicts_differ": verdict_disagree,
            "bp_converged": conv_tot / shots,
            "seconds_all": times["all"],
            "seconds_failed_scope": times["failed"],
        }
        print(f"{name}/{block}: all={fails['all']} failed-scope="
              f"{fails['failed']} verdict-diff={verdict_disagree} "
              f"corr-diff={disagree} conv={conv_tot / shots:.4f} "
              f"speedup={times['all'] / max(times['failed'], 1e-9):.2f}x",
              flush=True)
    results[name] = out


def main():
    ap = argparse.ArgumentParser()
    here = os.path.dirname(__file__)
    ap.add_argument("--out", default=os.path.join(
        here, "results", "osd_scope_ler_r3.json"))
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    shots = 2048 if a.quick else 32768

    import jax

    results = {"device": str(jax.devices()[0]),
               "note": ("OSD-0 on a syndrome-consistent BP solution is an "
                        "identity (the non-pivot assignment IS bp_err, so "
                        "the pivot solve reproduces it); scope can therefore "
                        "only matter for osd_order > 0, where the sweep may "
                        "prefer a lower-weight candidate on converged lanes")}
    run_case("toric_d3_R3_p02_w0", lt.toric_code_x(3), lt.toric_code_z(3),
             3, 0.02, shots, 2048, 60, 11, results)
    run_case("toric_d3_R3_p02_w2", lt.toric_code_x(3), lt.toric_code_z(3),
             3, 0.02, shots, 2048, 60, 11, results, osd_order=2)
    Hx, Hz, *_ = lt.named_bicycle_code("bb144")
    run_case("bb144_R6_p005_w0", Hx, Hz, 6, 0.005, shots, 1024, 60, 13,
             results)
    run_case("bb144_R6_p005_w2", Hx, Hz, 6, 0.005, shots, 1024, 60, 13,
             results, osd_order=2)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", a.out)


if __name__ == "__main__":
    main()
