"""Command-line interface: FER sweeps and throughput benchmarks.

The reference has no CLI (configuration is constructor args only); this
is an addition for production use:

    python -m ldpcdecoders_tpu sweep --code gallager:1000,10,9 \
        --decoder bposd --pers 0.005,0.01,0.02 --trials 10000 \
        --batch 4096 --checkpoint sweep.json

    python -m ldpcdecoders_tpu bench --code gallager:1000,10,9 \
        --decoder minsum --batch 1024
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_code(spec: str):
    """Return ``(H, qc)`` — the parity-check matrix plus, for quasi-cyclic
    specs, the ``(base, Z)`` structure the QC decoder needs (None otherwise)."""
    import ldpcdecoders_tpu as lt

    kind, _, args = spec.partition(":")
    if kind == "gallager":
        n, wr, wc = (int(x) for x in args.split(","))
        return lt.parity_check_matrix(n, wr, wc, rng=42), None
    if kind == "toric":
        return lt.toric_code_x(int(args)), None
    if kind == "surface":
        return lt.surface_code_x(int(args)), None
    if kind == "repetition":
        return lt.repetition_code(int(args)), None
    if kind == "hamming":
        return lt.hamming_code(int(args)), None
    if kind == "bicycle":
        Hx, _, _ = lt.named_bicycle_code(args)
        return Hx, None  # X stabilizer block (as toric:d uses toric_code_x)
    if kind == "qc":
        nb, wr, wc, Z = (int(x) for x in args.split(","))
        base = lt.random_qc_base_matrix(nb, wr, wc, Z, rng=42)
        return lt.qc_lift(base, Z), (base, Z)
    if kind == "qcbase":
        base, Z = lt.load_base_matrix(args)
        return lt.qc_lift(base, Z), (base, Z)
    if kind == "pcm":
        return lt.load_pcm(args), None
    if kind == "npz":
        from ldpcdecoders_tpu.utils import load_code_npz

        return load_code_npz(args)[0], None
    raise SystemExit(f"unknown code spec '{spec}'")


def _build_css_pair(spec: str):
    """Return ``(Hx, Hz)`` for CSS code specs (toric:d, surface:d,
    bicycle:name) — the pair the logical-error commands need."""
    import ldpcdecoders_tpu as lt

    kind, _, args = spec.partition(":")
    if kind == "toric":
        return lt.toric_code_x(int(args)), lt.toric_code_z(int(args))
    if kind == "surface":
        return lt.surface_code_x(int(args)), lt.surface_code_z(int(args))
    if kind == "bicycle":
        Hx, Hz, _ = lt.named_bicycle_code(args)
        return Hx, Hz
    raise SystemExit(
        f"'{spec}' is not a CSS pair spec (logical sweeps need toric:d, "
        "surface:d, or bicycle:name)"
    )


def _decoder_factory(name: str, H, max_iters: int, osd_order: int, T: int, C: float, fused: bool = False, osd_scope: str = 'all', qc=None, schedule: str = 'flooding', schedule_file=None, osd_method: str = 'exhaustive'):
    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.config import DecoderConfig

    table = {
        "bp": lambda per: lt.BeliefPropagationDecoder(H, per, max_iters),
        "bposd": lambda per: lt.BeliefPropagationOSDDecoder(
            H, per, max_iters, osd_order=osd_order, fused=fused,
            osd_scope=osd_scope, osd_method=osd_method,
        ),
        "bitflip": lambda per: lt.BitFlipDecoder(H, per, max_iters),
        "bpots": lambda per: lt.BPOTSDecoder(H, per, max_iters, T=T, C=C),
        "minsum": lambda per: lt.MinSumDecoder(H, per, max_iters),
        "minsum_int8": lambda per: lt.QuantizedMinSumDecoder(H, per, max_iters),
        "layered_minsum": lambda per: lt.LayeredMinSumDecoder(H, per, max_iters),
        "qc_minsum": lambda per: DecoderConfig(
            kind="qc_minsum", per=per, max_iters=max_iters, schedule=schedule
        ).build(qc),
        "neural_minsum": lambda per: DecoderConfig(
            kind="neural_minsum", per=per, max_iters=max_iters,
            schedule_path=schedule_file,
        ).build(H),
    }
    if name not in table:
        raise SystemExit(f"unknown decoder '{name}' (choose from {sorted(table)})")
    if name == "qc_minsum" and qc is None:
        raise SystemExit(
            "decoder 'qc_minsum' needs a quasi-cyclic code spec "
            "(--code qc:nb,wr,wc,Z or qcbase:path)"
        )
    return table[name]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ldpcdecoders_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--code", default=None, help="gallager:n,wr,wc | toric:d | surface:d | repetition:n | hamming:r | qc:nb,wr,wc,Z | qcbase:path | bicycle:name | pcm:path | npz:path")
    common.add_argument("--decoder", default="bposd")
    common.add_argument("--max-iters", type=int, default=100)
    common.add_argument("--osd-order", type=int, default=0)
    common.add_argument("--fused", action="store_true",
                        help="bposd: single-program BP+OSD (no host sync)")
    common.add_argument("--osd-scope", default="all", choices=("all", "failed"),
                        help="bposd: run OSD-w on all lanes (reference) or "
                        "failing lanes only (throughput deviation)")
    common.add_argument("--osd-method", default="exhaustive",
                        choices=("exhaustive", "combination_sweep"),
                        help="bposd: reference 2^w sweep, or OSD-CS "
                        "(singles + pairs within --osd-order columns)")
    common.add_argument("--schedule-file", default=None,
                        help="npz schedule from `train` (neural_minsum)")
    common.add_argument("--schedule", default="flooding",
                        choices=("flooding", "layered"),
                        help="qc_minsum: message-passing schedule")
    common.add_argument("--T", type=int, default=9)
    common.add_argument("--C", type=float, default=2.0)
    common.add_argument("--batch", type=int, default=1024)
    common.add_argument("--profile", default=None, help="Perfetto trace dir")

    sp = sub.add_parser("sweep", parents=[common], help="FER sweep with checkpoint/resume")
    sp.add_argument("--pers", required=True, help="comma-separated physical error rates")
    sp.add_argument(
        "--erasure-rates", default=None,
        help="comma-separated erasure rates: runs the mixed erasure+flip "
        "sweep (MixedChannelDecoder with OSD completion at --osd-order; "
        "--pers must then be the single flip rate)",
    )
    sp.add_argument("--trials", type=int, default=10000)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-seconds", type=float, default=None)

    bp = sub.add_parser("bench", parents=[common], help="throughput benchmark")
    bp.add_argument("--per", type=float, default=0.01)
    bp.add_argument("--reps", type=int, default=5, help="timed repetitions (median reported)")

    th = sub.add_parser(
        "threshold", parents=[common],
        help="bisect the per where LER crosses a target",
    )
    th.add_argument("--target-ler", type=float, default=1e-2)
    th.add_argument("--lo", type=float, default=1e-4)
    th.add_argument("--hi", type=float, default=0.2)
    th.add_argument("--trials", type=int, default=2000, help="trials per probe")
    th.add_argument("--seed", type=int, default=0)
    th.add_argument("--max-probes", type=int, default=12)

    tr = sub.add_parser(
        "train", parents=[common],
        help="train a neural min-sum schedule and save it to npz",
    )
    tr.add_argument("--per", type=float, default=0.01, help="training noise rate")
    tr.add_argument("--per-range", default=None,
                    help="lo,hi — train a rate-robust schedule instead")
    tr.add_argument("--steps", type=int, default=300)
    tr.add_argument("--train-batch", type=int, default=256)
    tr.add_argument("--lr", type=float, default=2e-2)
    tr.add_argument("--param-scope", default="iteration",
                    choices=("iteration", "edge"))
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--out", required=True, help="output npz path")

    lg = sub.add_parser(
        "logical", parents=[common],
        help="degeneracy-aware logical-error sweep of a CSS pair "
             "(toric:d | surface:d | bicycle:name); --rounds > 1 decodes "
             "noisy measurement rounds jointly (phenomenological model)")
    lg.add_argument("--pers", default=None,
                    help="comma-separated physical error rates "
                         "(required unless --dem)")
    lg.add_argument("--trials", type=int, default=4096)
    lg.add_argument("--rounds", type=int, default=1,
                    help="syndrome-measurement rounds per shot (1 = perfect "
                         "measurements, i.e. css_logical_sweep)")
    lg.add_argument("--meas-error-rate", type=float, default=None,
                    help="readout flip rate per bit/round (default: per); "
                         "needs --rounds > 1")
    lg.add_argument("--loss-rate", type=float, default=0.0,
                    help="heralded qubit-loss fraction (rounds=1 only)")
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--dem", default=None, metavar="FILE",
                    help="decode a detector error model file instead of a "
                         "CSS pair: observable-prediction error rate via "
                         "dem_logical_sweep (--trials shots; --rounds is "
                         "metadata for the per-round rate; --pers ignored)")

    dm = sub.add_parser(
        "dem",
        help="build a CSS pair's memory-experiment circuit and write its "
             "exact detector error model (flattened stim format)")
    dm.add_argument("--code", required=True,
                    help="CSS pair spec (toric:d | surface:d | bicycle:name)")
    dm.add_argument("--rounds", type=int, default=3)
    dm.add_argument("--p", type=float, required=True,
                    help="uniform circuit-level depolarizing rate (sets all "
                         "four noise knobs)")
    dm.add_argument("--basis", default="z", choices=("z", "x"))
    dm.add_argument("--out", required=True, help="output .dem path")

    a = ap.parse_args(argv)

    if a.cmd not in ("dem",) and getattr(a, "dem", None) is None \
            and a.code is None:
        ap.error("--code is required (unless 'logical --dem FILE')")

    if a.cmd == "dem":
        from ldpcdecoders_tpu.codes.circuit import css_memory_circuit, dem_text

        Hx, Hz = _build_css_pair(a.code)
        circ = css_memory_circuit(Hx, Hz, a.rounds, p=a.p, basis=a.basis)
        txt = (f"# {a.code} memory-{a.basis}, {a.rounds} rounds, uniform "
               f"circuit-level depolarizing p={a.p}\n" + dem_text(circ))
        with open(a.out, "w") as f:
            f.write(txt)
        print(json.dumps({
            "out": a.out, "detectors": len(circ.detectors),
            "observables": len(circ.observables),
            "mechanisms": sum(1 for line in txt.splitlines()
                              if line.startswith("error"))}))
        return 0

    from ldpcdecoders_tpu.cache import enable_compilation_cache
    from ldpcdecoders_tpu.harness import FERSweep, find_threshold
    from ldpcdecoders_tpu.utils.profiling import trace

    enable_compilation_cache()

    if a.cmd == "logical" and a.dem is not None:
        from ldpcdecoders_tpu.harness import dem_logical_sweep

        with trace(a.profile):
            out = dem_logical_sweep(
                a.dem, shots=a.trials, max_iters=a.max_iters,
                decoder=a.decoder, batch=a.batch, seed=a.seed,
                rounds=a.rounds if a.rounds > 1 else None,
                osd_order=a.osd_order)
        print(json.dumps(out, indent=2))
        return 0

    if a.cmd == "logical":
        from ldpcdecoders_tpu.harness import (
            css_logical_sweep,
            spacetime_logical_sweep,
        )

        if a.pers is None:
            raise SystemExit("--pers is required for CSS-pair sweeps")
        Hx, Hz = _build_css_pair(a.code)
        pers = [float(x) for x in a.pers.split(",")]
        knobs = dict(decoder=a.decoder, max_iters=a.max_iters,
                     batch=a.batch, seed=a.seed, osd_order=a.osd_order)
        with trace(a.profile):
            if a.rounds > 1:
                if a.loss_rate:
                    raise SystemExit(
                        "--loss-rate is a rounds=1 feature (heralded loss "
                        "under perfect measurements)")
                out = spacetime_logical_sweep(
                    Hx, Hz, pers, rounds=a.rounds,
                    meas_error_rate=a.meas_error_rate,
                    trials_per_point=a.trials, **knobs)
            else:
                if a.meas_error_rate is not None:
                    raise SystemExit("--meas-error-rate needs --rounds > 1")
                out = css_logical_sweep(
                    Hx, Hz, pers, trials_per_point=a.trials,
                    loss_rate=a.loss_rate, **knobs)
        print(json.dumps({str(k): v for k, v in out.items()}, indent=2))
        return 0

    H, qc = _build_code(a.code)
    if a.cmd == "train":
        from ldpcdecoders_tpu.models.neural import NeuralMinSumDecoder

        dec = NeuralMinSumDecoder(
            H, a.per, a.max_iters, param_scope=a.param_scope
        )
        kw = {}
        if a.per_range:
            lo, hi = (float(x) for x in a.per_range.split(","))
            kw["per_range"] = (lo, hi)
        t0 = time.perf_counter()
        hist = dec.train(
            steps=a.steps, batch=a.train_batch, lr=a.lr, seed=a.seed, **kw
        )
        dec.save_schedule(a.out)
        print(json.dumps({
            "schedule": a.out,
            "param_scope": a.param_scope,
            "steps": a.steps,
            "loss_first": round(hist["losses"][0], 6),
            "loss_last": round(hist["losses"][-1], 6),
            "train_seconds": round(time.perf_counter() - t0, 2),
        }))
        return 0
    factory = _decoder_factory(a.decoder, H, a.max_iters, a.osd_order, a.T, a.C, a.fused, a.osd_scope, qc=qc, schedule=a.schedule, schedule_file=a.schedule_file, osd_method=a.osd_method)

    with trace(a.profile):
        if a.cmd == "sweep" and a.erasure_rates:
            from ldpcdecoders_tpu.harness import mixed_fer_sweep

            pers = [float(x) for x in a.pers.split(",")]
            if len(pers) != 1:
                raise SystemExit(
                    "--erasure-rates sweeps the erasure axis; give exactly "
                    "one --pers value (the fixed flip rate)"
                )
            # fail loudly on flags this path cannot honor rather than
            # silently dropping them (the decoder is MixedChannelDecoder)
            if a.decoder != "bposd":  # the parser default
                raise SystemExit(
                    "--erasure-rates always decodes with MixedChannelDecoder"
                    " (min-sum + OSD completion); drop --decoder"
                )
            rates = [float(x) for x in a.erasure_rates.split(",")]
            out = mixed_fer_sweep(
                H, pers[0], rates, trials_per_point=a.trials,
                batch=a.batch, seed=a.seed, osd_order=a.osd_order,
                max_iters=a.max_iters, checkpoint_path=a.checkpoint,
                max_seconds=a.max_seconds,
            )
            print(json.dumps({str(k): v for k, v in out.items()}, indent=2))
        elif a.cmd == "sweep":
            pers = [float(x) for x in a.pers.split(",")]
            sweep = FERSweep(
                H,
                factory,
                pers,
                batch=a.batch,
                checkpoint_path=a.checkpoint,
                seed=a.seed,
            )
            out = sweep.run(trials_per_point=a.trials, max_seconds=a.max_seconds)
            print(json.dumps({str(k): v for k, v in out.items()}, indent=2))
        elif a.cmd == "threshold":
            res = find_threshold(
                H,
                factory,
                target_ler=a.target_ler,
                lo=a.lo,
                hi=a.hi,
                trials_per_probe=a.trials,
                batch=a.batch,
                seed=a.seed,
                max_probes=a.max_probes,
            )
            print(json.dumps(res, indent=2))
        elif a.cmd == "bench":
            # bench.py's methodology: compile+warmup call excluded, then a
            # fixed number of timed repetitions with the median reported
            # (a single timed call is dispatch-noise-bound) plus the
            # min/max spread as a dispersion figure
            dec = factory(a.per)
            rng = np.random.default_rng(0)
            errs = rng.random((a.batch, H.shape[1])) < a.per
            syns = (errs @ H.T) % 2
            dec.batch_decode(syns)  # compile + warmup
            times = []
            for _ in range(max(1, a.reps)):
                t0 = time.perf_counter()
                _, conv, iters, _, stats = dec.batch_decode_detailed(syns)
                times.append(time.perf_counter() - t0)
            times.sort()
            med = times[len(times) // 2]
            print(
                json.dumps(
                    {
                        "decoder": a.decoder,
                        "batch": a.batch,
                        "reps": len(times),
                        "syndromes_per_s": round(a.batch / med, 1),
                        "time_median_ms": round(med * 1e3, 3),
                        "time_min_ms": round(times[0] * 1e3, 3),
                        "time_max_ms": round(times[-1] * 1e3, 3),
                        "spread_pct": round(100 * (times[-1] - times[0]) / med, 1),
                        "converged_fraction": stats.converged_fraction,
                        "mean_iters": round(stats.mean_iters, 2),
                    }
                )
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
