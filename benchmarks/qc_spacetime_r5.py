"""bb144 space-time: QC-layered inner vs incumbent (VERDICT r4 item 5).

Round 4 measured that a QC whole-decode kernel (since removed) hosted the bb144 space-time
blocks exactly and that the LAYERED schedule converges 100% of lanes in
60 iterations where flooding leaves 0.5% to OSD — but the result sat
unwired.  Round 5 wired it (`SpaceTimeDecoder.for_bicycle`, mixed
per/q priors as a vector prior); this script takes
the done-bar measurement: the SAME sampled detector records decoded by

  * the incumbent inner (``decoder="bposd"`` on the space-time matrix,
    the spacetime_ler.py configuration), and
  * the QC-layered inner (``SpaceTimeDecoder.for_bicycle``),

with X-block logical verdicts by stabilizer equivalence (the decoded
cumulative data correction must differ from the truth by a stabilizer,
i.e. lie in rowspan(Hx)).

Usage: python benchmarks/qc_spacetime_r5.py [--rounds 6] [--shots 8192]
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--p", type=float, default=0.003)
    ap.add_argument("--shots", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import jax

    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.models.spacetime import SpaceTimeDecoder
    from ldpcdecoders_tpu.utils.metrics import gf2_rowspan_reducer

    Hx, Hz, _ = lt.named_bicycle_code("bb144")
    R, p = a.rounds, a.p
    inc = SpaceTimeDecoder(Hx, R, p, a.max_iters, decoder="bposd")
    qcl = SpaceTimeDecoder.for_bicycle(
        "bb144", "x", R, p, a.max_iters, schedule="layered")
    assert (qcl.A != inc.A).nnz == 0  # identical space-time model

    # residuals satisfying Hx r = 0 are harmless iff they lie in the
    # OPPOSITE block's row span (Z stabilizers) — see the reducer's
    # docstring; anything else is a logical operator
    reduce_z = gf2_rowspan_reducer(np.asarray(Hz))
    rng = np.random.default_rng(a.seed)
    A = inc.A.toarray()
    n_cols, block_n = inc.n_cols, inc.block_n
    prior = inc._prior

    res = {"device": str(jax.devices()[0]),
           "case": f"bb144 space-time R={R} p=q={p}, paired shots",
           "shots": a.shots, "max_iters": a.max_iters,
           "arms": {}}
    stats = {"incumbent_bposd": {"fail": 0, "conv": 0, "wall": 0.0},
             "qc_layered": {"fail": 0, "conv": 0, "wall": 0.0}}
    decs = {"incumbent_bposd": inc, "qc_layered": qcl}
    trials = 0
    for lo in range(0, a.shots, a.batch):
        b = min(a.batch, a.shots - lo)
        x = (rng.random((b, n_cols)) < prior[None, :]).astype(np.uint8)
        det = (x @ A.T % 2).astype(np.uint8)
        true_cum = x[:, : R * block_n].reshape(
            b, R, block_n).sum(axis=1) % 2
        trials += b
        for name, dec in decs.items():
            t0 = time.perf_counter()
            err, conv = dec.batch_decode(det)
            dt = time.perf_counter() - t0
            diff = (np.asarray(err).astype(np.uint8) ^
                    true_cum.astype(np.uint8))
            # logical failure = residual outside the stabilizer span
            fail = ~reduce_z(diff)
            stats[name]["fail"] += int(fail.sum())
            stats[name]["conv"] += int(np.asarray(conv).sum())
            stats[name]["wall"] += dt
        print(f"{trials}/{a.shots}", {k: v["fail"] for k, v in
                                      stats.items()}, flush=True)

    from ldpcdecoders_tpu.utils.metrics import wilson_interval

    for name, s in stats.items():
        lo_, hi_ = wilson_interval(s["fail"], trials)
        res["arms"][name] = {
            "fails": s["fail"], "ler": s["fail"] / trials,
            "ler_ci95": [lo_, hi_],
            "converged": s["conv"] / trials,
            "shots_per_s": round(trials / s["wall"], 1),
        }
    r_inc = res["arms"]["incumbent_bposd"]
    r_qc = res["arms"]["qc_layered"]
    res["speedup_qc_vs_incumbent"] = round(
        r_qc["shots_per_s"] / r_inc["shots_per_s"], 2)
    res["ler_compatible"] = bool(
        r_qc["ler_ci95"][0] <= r_inc["ler_ci95"][1]
        and r_inc["ler_ci95"][0] <= r_qc["ler_ci95"][1])
    print(json.dumps(res))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
