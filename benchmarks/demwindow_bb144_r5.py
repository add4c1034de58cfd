"""bb144 R=12 circuit-level: windowed vs joint, round 5 (VERDICT item 2).

Round 4 measured the failure honestly: windows at W=3-5 with a K=3
relay-1 deep-500 inner collapsed to 0.64 window convergence and LER
0.22-0.31 vs joint 0.0035-0.014 — and the production-strength inner
ran out of device memory at bb144 width.  Round 5 re-attempts with the levers that
change both terms:

  * the deep path is ~2x cheaper per iteration (argmin-free check
    update + bf16 members), so every window can afford the PRODUCTION
    inner (K=6 disordered-memory + relay restarts);
  * staged batch/bucket ceilings now derive from the device budget
    (utils/hbm.py), so wide window models chunk instead of crashing;
  * W is chosen several rounds past the mechanism span per the measured
    guidance in models/demwindow.py.

Paired design: the SAME sampled shots decode through the joint staged
decoder and the windowed decoder, so the comparison is CI-free of
shot-noise between arms.

Usage:
  python benchmarks/demwindow_bb144_r5.py --shots 1024 --window 6 \
      --commit 2 [--members 6] [--relay 4] [--out results.jsonl]
"""

import argparse
import json
import os
import time

import numpy as np

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
DMEM = (-0.24, 0.66)


def load_dem(rounds: int, p: float):
    import scipy.sparse as sp

    path = os.path.join(RESULTS, f"bb144_r{rounds}_p{p}.npz")
    if os.path.exists(path):
        z = np.load(path)
        A = sp.csr_matrix(
            (z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
        return A, z["priors"], z["obs"]
    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.codes.circuit import circuit_dem, css_memory_circuit

    Hx, Hz, *_ = lt.named_bicycle_code("bb144")
    c = css_memory_circuit(Hx, Hz, rounds, p=p)
    A, pr, O = circuit_dem(c)
    A = sp.csr_matrix(A)
    np.savez_compressed(
        path, data=A.data, indices=A.indices, indptr=A.indptr,
        shape=np.array(A.shape), priors=np.asarray(pr), obs=np.asarray(O))
    return A, np.asarray(pr), np.asarray(O)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=float, default=0.003)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--commit", type=int, default=2)
    ap.add_argument("--members", type=int, default=6)
    ap.add_argument("--relay", type=int, default=4)
    ap.add_argument("--stage0", type=int, default=96)
    ap.add_argument("--deep", type=int, default=500)
    ap.add_argument("--lam", type=int, default=60)
    ap.add_argument("--lam3", type=int, default=40)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--skip-joint", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ldpcdecoders_tpu.models.demwindow import WindowedDemDecoder
    from ldpcdecoders_tpu.models.staged import StagedDemDecoder

    A, pr, O = load_dem(a.rounds, a.p)
    D, N = A.shape
    dpr = D // a.rounds
    gammas = (0.4,) + tuple(DMEM for _ in range(max(0, a.members - 1)))

    rng = np.random.default_rng(a.seed)
    Ad = A.toarray()
    x = (rng.random((a.shots, N)) < pr[None, :]).astype(np.uint8)
    det = (x @ Ad.T % 2).astype(np.uint8)
    obs_true = (x @ O.T % 2).astype(np.uint8)
    res = {
        "device": str(jax.devices()[0]),
        "case": (f"bb144 R={a.rounds} p={a.p} paired joint-vs-windowed, "
                 "production inner"),
        "dem": {"detectors": int(D), "mechanisms": int(N),
                "rounds": a.rounds, "detectors_per_round": int(dpr)},
        "shots": a.shots,
        "config": {"window": a.window, "commit": a.commit,
                   "members": a.members, "relay_legs": a.relay,
                   "stage0_iters": a.stage0, "deep_iters": a.deep,
                   "deep_dtype": "bf16", "lam": a.lam, "lam3": a.lam3},
    }

    if not a.skip_joint:
        joint = StagedDemDecoder(
            A, pr, observables=O, gammas=gammas, stage0_iters=a.stage0,
            deep_iters=a.deep, lam=a.lam, lam3=a.lam3, check_every=8,
            relay_legs=a.relay, deep_dtype=jnp.bfloat16, layout="check")
        t0 = time.perf_counter()
        pj = []
        for lo in range(0, a.shots, a.batch):
            fl, _ = joint.predict_observables(det[lo:lo + a.batch],
                                              seed=a.seed)
            pj.append(fl)
        pj = np.concatenate(pj)
        tj = time.perf_counter() - t0
        jfail = (pj != obs_true).any(axis=1)
        res["joint"] = {
            "ler": float(jfail.mean()), "fails": int(jfail.sum()),
            "shots_per_s": round(a.shots / tj, 2),
            "rounds_per_s": round(a.shots * a.rounds / tj, 1),
        }
        print("joint:", json.dumps(res["joint"]), flush=True)

    win = WindowedDemDecoder(
        A, pr, detectors_per_round=dpr, window=a.window, commit=a.commit,
        observables=O, decoder="staged", max_iters=a.deep,
        gammas=gammas, stage0_iters=a.stage0, lam=a.lam, lam3=a.lam3,
        check_every=8, relay_legs=a.relay, deep_dtype=jnp.bfloat16,
        layout="check")
    t0 = time.perf_counter()
    pw = []
    infos = []
    for lo in range(0, a.shots, a.batch):
        fl, info = win.predict_observables(det[lo:lo + a.batch],
                                           seed=a.seed)
        pw.append(fl)
        infos.append(info)
    pw = np.concatenate(pw)
    tw = time.perf_counter() - t0
    wfail = (pw != obs_true).any(axis=1)
    res["windowed"] = {
        "ler": float(wfail.mean()), "fails": int(wfail.sum()),
        "window_converged": float(np.mean([i["converged"] for i in infos])),
        "windows": infos[0]["windows"],
        "shots_per_s": round(a.shots / tw, 2),
        "rounds_per_s": round(a.shots * a.rounds / tw, 1),
    }
    if not a.skip_joint:
        res["prediction_agreement"] = float((pw == pj).all(axis=1).mean())
        from ldpcdecoders_tpu.utils.metrics import wilson_interval

        res["joint"]["ci95"] = list(wilson_interval(
            res["joint"]["fails"], a.shots))
        res["windowed"]["ci95"] = list(wilson_interval(
            res["windowed"]["fails"], a.shots))
    print(json.dumps(res))
    if a.out:
        with open(a.out, "a") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
