"""FER/LER sweep harness with checkpoint/resume.

Elevates the reference tests' ad-hoc LER measurements
(test_bp_decoder.jl:19-43) into a first-class evaluation tool
(SURVEY.md §7.2 step 8): batched decoding per physical-error-rate point,
accumulated trial/failure counts checkpointed to JSON after every batch so
long sweeps survive interruption, and structured per-point statistics
(FER, exact-recovery LER, syndrome-match rate, converged fraction, Wilson
intervals).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np

from .models.base import Decoder
from .utils.io import atomic_write_json, read_json
from .utils.metrics import wilson_interval
from .utils.noise import (
    sample_errors,
    sample_mixed_channel,
    syndromes_of,
    verify_decodes,
)

__all__ = ["FERSweep", "SweepPoint", "find_threshold", "css_logical_sweep",
           "mixed_fer_sweep", "spacetime_logical_sweep", "dem_logical_sweep"]


@dataclasses.dataclass
class SweepPoint:
    """Accumulated statistics at one physical error rate."""

    per: float
    trials: int = 0
    steps: int = 0  # batches decoded; indexes this point's RNG streams
    exact_failures: int = 0  # estimate != injected error
    syndrome_mismatches: int = 0  # estimate does not reproduce syndrome
    non_converged: int = 0
    total_iters: int = 0
    wall_seconds: float = 0.0

    @property
    def ler(self) -> float:
        return self.exact_failures / self.trials if self.trials else 0.0

    @property
    def syndrome_match_rate(self) -> float:
        return 1.0 - (self.syndrome_mismatches / self.trials) if self.trials else 1.0

    @property
    def converged_fraction(self) -> float:
        return 1.0 - (self.non_converged / self.trials) if self.trials else 1.0

    def summary(self) -> dict:
        lo, hi = wilson_interval(self.exact_failures, self.trials)
        return {
            "per": self.per,
            "trials": self.trials,
            "ler": self.ler,
            "ler_ci95": [lo, hi],
            "syndrome_match_rate": self.syndrome_match_rate,
            "converged_fraction": self.converged_fraction,
            "mean_iters": self.total_iters / self.trials if self.trials else 0.0,
            "throughput_syndromes_per_s": (
                self.trials / self.wall_seconds if self.wall_seconds else 0.0
            ),
        }


class FERSweep:
    """Checkpointable frame-error-rate sweep over physical error rates.

    Args:
      H: parity-check matrix.
      decoder_factory: ``per -> Decoder`` (a fresh decoder per noise point,
        mirroring how the reference constructs decoders with the channel
        prior baked in).
      pers: physical error rates to sweep.
      batch: syndromes decoded per step (global across hosts when
        multi-host).
      checkpoint_path: optional JSON path; progress is saved after every
        batch and picked up on restart.
      seed: base seed; each (point, batch) pair derives its own stream, so
        resumed runs reproduce the uninterrupted run exactly.
      multihost: shard each step's trials across ``jax.process_count()``
        processes (SURVEY.md §5's per-host trial sharding): every process
        decodes a disjoint slice on disjoint RNG streams and the counts
        are summed with :func:`parallel.multihost.allreduce_counts`; only
        process 0 writes checkpoints.  Default: auto (on when the process
        group has more than one member).
      pipeline: number of batches in flight on the device (single-host
        only; multihost runs synchronously to keep collectives ordered).
        Each step is dispatched with
        :meth:`~ldpcdecoders_tpu.models.base.Decoder.batch_decode_detailed_async`
        and host-side sampling/verification of neighboring batches runs
        while the device decodes — results are bit-identical to the
        synchronous loop (streams derive from the step index alone, and
        batches finalize in dispatch order).  1 disables overlap.
      sample_on_device: generate the error patterns and syndromes inside
        the fused device step (``jax.random`` keyed by the same
        (seed, point, step) derivation, so interrupted runs still resume
        on exact streams) — the whole trial batch becomes ONE device
        program with a ``[4]`` count fetch, and per-batch host work drops
        to ~zero.  Opt-in because the noise streams are jax.random rather
        than the NumPy streams host sampling draws, so accumulated counts
        are statistically equivalent but not bitwise comparable with a
        host-sampled sweep (or with checkpoints written by one; resuming
        a checkpoint across a sampling-mode switch raises).  Requires a
        dense H and a decoder whose ``_decode_batch`` traces; falls back
        to host sampling otherwise.
    """

    def __init__(
        self,
        H,
        decoder_factory: Callable[[float], Decoder],
        pers: Sequence[float],
        *,
        batch: int = 256,
        checkpoint_path: str | None = None,
        seed: int = 0,
        multihost: bool | None = None,
        pipeline: int = 4,
        sample_on_device: bool = False,
    ):
        # keep scipy.sparse H as-is: syndromes_of handles it natively, and
        # densifying a from_edges-scale code here would allocate gigabytes
        self.H = H if hasattr(H, "toarray") else np.asarray(H)
        self.decoder_factory = decoder_factory
        self.batch = int(batch)
        self.checkpoint_path = checkpoint_path
        self.seed = int(seed)
        # multihost auto-detection is deferred to run(): jax.process_count()
        # initializes the JAX backend, which must not happen before the user
        # has had a chance to call initialize_multihost()
        self.multihost: bool | None = None if multihost is None else bool(multihost)
        self.pipeline = max(1, int(pipeline))
        self.sample_on_device = bool(sample_on_device)
        self._dev_verify = None  # lazily jitted device-side count kernel
        self.points = {float(p): SweepPoint(per=float(p)) for p in pers}
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._load_checkpoint()

    # -- checkpointing ----------------------------------------------------

    def _load_checkpoint(self):
        data = read_json(self.checkpoint_path)
        if data.get("seed") != self.seed or data.get("batch") != self.batch:
            raise ValueError(
                "checkpoint was written with a different seed/batch config"
            )
        if bool(data.get("sample_on_device", False)) != self.sample_on_device:
            raise ValueError(
                "checkpoint was written with a different sampling mode "
                "(host vs device noise streams are not interchangeable)"
            )
        for rec in data["points"]:
            p = float(rec["per"])
            if p in self.points:
                self.points[p] = SweepPoint(**rec)

    def _save_checkpoint(self):
        if not self.checkpoint_path:
            return
        if self.multihost:
            import jax

            if jax.process_index() != 0:
                return
        atomic_write_json(
            self.checkpoint_path,
            {
                "seed": self.seed,
                "batch": self.batch,
                "sample_on_device": self.sample_on_device,
                "points": [dataclasses.asdict(pt) for pt in self.points.values()],
            },
        )

    def _sync_points_from_host0(self):
        from .parallel.multihost import broadcast_from_host0

        pers = sorted(self.points)
        state = np.asarray(
            [
                [
                    pt.trials,
                    pt.steps,
                    pt.exact_failures,
                    pt.syndrome_mismatches,
                    pt.non_converged,
                    pt.total_iters,
                    pt.wall_seconds,
                ]
                for pt in (self.points[p] for p in pers)
            ],
            dtype=np.float64,
        )
        for p, row in zip(pers, broadcast_from_host0(state)):
            self.points[p] = SweepPoint(
                per=p,
                trials=int(row[0]),
                steps=int(row[1]),
                exact_failures=int(row[2]),
                syndrome_mismatches=int(row[3]),
                non_converged=int(row[4]),
                total_iters=int(row[5]),
                wall_seconds=float(row[6]),
            )

    # -- running ----------------------------------------------------------

    def _device_verify(self):
        """Jitted on-device batch verification (dense H only).

        Fetching the ``[B, n]`` guesses to verify host-side costs multiple
        device->host round trips per batch, several times the decode
        itself.  Instead the counts the
        sweep actually accumulates are reduced on device and fetched as ONE
        ``[4]`` int32 vector: (exact failures, syndrome mismatches,
        non-converged, total iterations).  The f32 MXU matmul is exact
        (per-check 0/1 overlap counts are far below 2^24).
        """
        if self._dev_verify is None:
            import jax
            import jax.numpy as jnp

            Hd = jnp.asarray(np.asarray(self.H), jnp.float32)

            @jax.jit
            def fn(guesses, errs, syns, conv, iters):
                exact = jnp.all(guesses.astype(jnp.int8) == errs.astype(jnp.int8),
                                axis=1)
                synhat = jnp.mod(guesses.astype(jnp.float32) @ Hd.T, 2.0)
                smatch = jnp.all(synhat == syns.astype(jnp.float32), axis=1)
                return jnp.stack([
                    jnp.sum(~exact, dtype=jnp.int32),
                    jnp.sum(~smatch, dtype=jnp.int32),
                    jnp.sum(~conv, dtype=jnp.int32),
                    jnp.sum(iters, dtype=jnp.int32),
                ])

            self._dev_verify = fn
        return self._dev_verify

    def _make_fused_step(self, decoder, per: float, use_per_kw: bool):
        """Jit decode + verification into ONE device program.

        Separate decode/verify dispatches each block on the host;
        fusing them (tracing through the decoder's
        ``_decode_batch``) leaves one dispatch and one ``[4]`` int32 fetch
        per batch — measured 21 ms vs ~100 ms per 1024-lane batch, and XLA
        dead-code-eliminates decoder aux outputs (e.g. LLRs) the sweep
        never reads.  ``per`` is closed over statically (one compile per
        noise point; the persistent cache absorbs re-runs).  Decoders with
        host-side orchestration (OSD lane compaction, bucketing) fail to
        trace and the caller falls back to the two-dispatch path.
        """
        import jax
        import jax.numpy as jnp

        Hd = jnp.asarray(np.asarray(self.H), jnp.float32)
        kw = {"per": float(per)} if use_per_kw else {}

        def step(syns, errs, seed):
            out = decoder._decode_batch(syns, seed, **kw)
            err, conv, iters = out[0], out[1], out[2]
            exact = jnp.all(err.astype(jnp.int8) == errs, axis=1)
            synhat = jnp.mod(err.astype(jnp.float32) @ Hd.T, 2.0)
            smatch = jnp.all(synhat == syns.astype(jnp.float32), axis=1)
            return jnp.stack([
                jnp.sum(~exact, dtype=jnp.int32),
                jnp.sum(~smatch, dtype=jnp.int32),
                jnp.sum(~conv, dtype=jnp.int32),
                jnp.sum(iters, dtype=jnp.int32),
            ])

        return jax.jit(step)

    def _make_device_step(self, decoder, per: float, use_per_kw: bool, b: int):
        """Fully device-resident sweep step: sample -> syndrome -> decode ->
        count, one program, one ``[4]`` fetch.

        The ``sample_on_device=True`` endgame of the dispatch-cost ladder
        (host verify ~271 ms -> native verify ~5 ms -> fused decode+verify
        one dispatch -> this: no per-batch host arrays at all).  Noise is
        ``jax.random.bernoulli`` keyed by the per-(point, step) seed the
        host derives — the same counted-stream discipline, so interrupted
        runs resume exactly; syndromes come from the same exact f32 MXU
        matmul the verification uses.
        """
        import jax
        import jax.numpy as jnp

        n = self.H.shape[1]
        Hd = jnp.asarray(np.asarray(self.H), jnp.float32)
        kw = {"per": float(per)} if use_per_kw else {}

        def step(noise_seed, decode_seed):
            key = jax.random.PRNGKey(noise_seed)
            errs = jax.random.bernoulli(key, per, (b, n))
            syns = jnp.mod(errs.astype(jnp.float32) @ Hd.T, 2.0).astype(jnp.uint8)
            out = decoder._decode_batch(syns, decode_seed, **kw)
            err, conv, iters = out[0], out[1], out[2]
            exact = jnp.all(err.astype(bool) == errs, axis=1)
            synhat = jnp.mod(err.astype(jnp.float32) @ Hd.T, 2.0)
            smatch = jnp.all(synhat == syns.astype(jnp.float32), axis=1)
            return jnp.stack([
                jnp.sum(~exact, dtype=jnp.int32),
                jnp.sum(~smatch, dtype=jnp.int32),
                jnp.sum(~conv, dtype=jnp.int32),
                jnp.sum(iters, dtype=jnp.int32),
            ])

        return jax.jit(step)

    def run(self, *, trials_per_point: int, max_seconds: float | None = None):
        """Accumulate until every point has ``trials_per_point`` trials.

        Returns ``{per: summary_dict}``.  Safe to interrupt and re-run.
        """
        t_start = time.perf_counter()
        # the fused step path calls decoders' _decode_batch directly,
        # bypassing _call_decode's first-use persistent-cache hook
        from .cache import ensure_default_cache

        ensure_default_cache()
        if self.multihost is None:
            import jax

            self.multihost = jax.process_count() > 1
        if self.multihost:
            # only process 0 writes checkpoints, so on a non-shared
            # filesystem only its loaded state is authoritative: adopt it
            # everywhere before any trial accounting happens
            self._sync_points_from_host0()
        n = self.H.shape[1]
        shared_decoder = None  # one compiled program reused across noise
        # points when the decoder supports per-call prior overrides
        per_kw_ok = True
        # batches in flight on the device: dispatch runs ahead of
        # verification so host-side sampling/popcount work overlaps device
        # decode; multihost stays synchronous (collective ordering)
        depth = 1 if self.multihost else self.pipeline
        stopping = False
        for per, pt in self.points.items():
            decoder = None
            per_kw = {}
            per_hash = int(per * 1e9) & 0x7FFFFFFF
            fused = None  # jitted decode+verify step (dense H, traceable
            # decoders); falls back to separate dispatches on trace failure
            fused_ok = not hasattr(self.H, "tocsr")
            dev_steps: dict = {}  # batch size -> fully device-resident step
            dev_ok = fused_ok and self.sample_on_device
            inflight: list = []  # (kind, payload, b_local, b_global)
            inflight_trials = 0
            step_cursor = pt.steps  # dispatch stream index; pt.steps counts
            # finalized batches, so a crash re-runs in-flight batches on
            # their exact original streams
            mark = time.perf_counter()

            def finalize_one():
                nonlocal inflight_trials, mark
                kind, payload, b_local, b_global = inflight.pop(0)
                if b_local > 0 and kind == "dev":
                    v = np.asarray(payload)  # one [4] fetch
                    counts = {
                        "trials": b_local,
                        "exact_failures": int(v[0]),
                        "syndrome_mismatches": int(v[1]),
                        "non_converged": int(v[2]),
                        "total_iters": int(v[3]),
                    }
                elif b_local > 0:
                    handles, errs, syns = payload
                    guesses, conv, iters, _aux = handles
                    guesses = np.asarray(guesses)
                    conv = np.asarray(conv)
                    iters = np.asarray(iters)
                    exact, smatch = verify_decodes(self.H, errs, guesses, syns)
                    counts = {
                        "trials": b_local,
                        "exact_failures": int(b_local - exact.sum()),
                        "syndrome_mismatches": int(b_local - smatch.sum()),
                        "non_converged": int(b_local - conv.sum()),
                        "total_iters": int(iters.sum()),
                    }
                else:
                    counts = {
                        "trials": 0,
                        "exact_failures": 0,
                        "syndrome_mismatches": 0,
                        "non_converged": 0,
                        "total_iters": 0,
                    }
                if self.multihost:
                    from .parallel.multihost import allreduce_counts, global_mesh

                    counts = allreduce_counts(counts, global_mesh())
                pt.trials += counts["trials"]
                pt.steps += 1
                pt.exact_failures += counts["exact_failures"]
                pt.syndrome_mismatches += counts["syndrome_mismatches"]
                pt.non_converged += counts["non_converged"]
                pt.total_iters += counts["total_iters"]
                now = time.perf_counter()
                pt.wall_seconds += now - mark
                mark = now
                inflight_trials -= b_global
                self._save_checkpoint()

            while pt.trials + inflight_trials < trials_per_point or inflight:
                if stopping and not inflight:
                    break
                want_more = (
                    not stopping
                    and pt.trials + inflight_trials < trials_per_point
                )
                if want_more and max_seconds is not None:
                    over = time.perf_counter() - t_start > max_seconds
                    if self.multihost:
                        # collective vote: local clocks diverge across
                        # processes, and a one-sided return would leave the
                        # survivors hanging in the next allgather
                        from .parallel.multihost import allreduce_counts, global_mesh

                        over = (
                            allreduce_counts({"stop": int(over)}, global_mesh())["stop"]
                            > 0
                        )
                    if over:
                        stopping = True
                        want_more = False
                if stopping and not inflight:
                    break
                if not want_more or len(inflight) >= depth:
                    finalize_one()
                    continue
                if decoder is None:
                    if shared_decoder is not None and per_kw_ok:
                        decoder = shared_decoder
                        per_kw = {"per": per}
                    else:
                        decoder = self.decoder_factory(per)
                        if shared_decoder is None and per_kw_ok:
                            shared_decoder = decoder
                            # pass per explicitly from the start so every
                            # noise point shares one traced program
                            per_kw = {"per": per}
                # each batch consumes its own counted stream; tracking the
                # step explicitly (not trials // batch) keeps resumed runs
                # on fresh streams even after a partial final batch
                step = step_cursor
                b = min(self.batch, trials_per_point - pt.trials - inflight_trials)
                if self.multihost:
                    import jax

                    P, pid = jax.process_count(), jax.process_index()
                    # disjoint per-process trial slice of the global batch
                    b_local = b // P + (1 if pid < b % P else 0)
                else:
                    pid, b_local = 0, b
                # noise + decoder RNG streams derive from
                # (seed, point, step, process) — the decoder stream gets a
                # salt so stochastic tie-breaking stays disjoint from (and
                # uncorrelated with) the injected noise, and a plain
                # seed+step would reuse identical streams across points
                rng = np.random.default_rng((self.seed, per_hash, step, pid))
                decode_seed = int(
                    np.random.default_rng(
                        (self.seed, per_hash, step, pid, 0xDEC0DE)
                    ).integers(1 << 31)
                )
                if b_local > 0:
                    rec = None
                    if dev_ok:
                        noise_seed = int(
                            np.random.default_rng(
                                (self.seed, per_hash, step, pid, 0x5A3D)
                            ).integers(1 << 31)
                        )
                        if b_local not in dev_steps:
                            dev_steps[b_local] = self._make_device_step(
                                decoder, per, bool(per_kw), b_local
                            )
                        try:
                            rec = ("dev", dev_steps[b_local](
                                noise_seed, decode_seed
                            ))
                        except Exception:
                            dev_ok = False
                    if rec is None:
                        errs = sample_errors(rng, b_local, n, per)
                        syns = syndromes_of(self.H, errs)
                    if rec is None and fused_ok:
                        if fused is None:
                            fused = self._make_fused_step(
                                decoder, per, bool(per_kw)
                            )
                        try:
                            rec = ("dev", fused(
                                syns, errs.astype(np.int8), decode_seed
                            ))
                        except Exception:
                            # untraceable decoder (host-side orchestration)
                            # or per-override rejection: use the eager path
                            fused_ok = False
                            fused = None
                    if rec is None:
                        try:
                            handles = decoder.batch_decode_detailed_async(
                                syns, seed=decode_seed, **per_kw
                            )
                        except ValueError:
                            if not per_kw:
                                raise
                            # decoder kind doesn't support prior overrides:
                            # fall back to one decoder per noise point
                            per_kw_ok = False
                            per_kw = {}
                            decoder = self.decoder_factory(per)
                            handles = decoder.batch_decode_detailed_async(
                                syns, seed=decode_seed
                            )
                        if not hasattr(self.H, "tocsr"):
                            # dense H: reduce the counts on device; only a
                            # [4] vector crosses back (see _device_verify)
                            rec = ("dev", self._device_verify()(
                                handles[0], errs.astype(np.int8), syns,
                                handles[1], handles[2],
                            ))
                        else:
                            rec = ("host", (handles, errs, syns))
                else:
                    rec = ("host", None)
                inflight.append((*rec, b_local, b))
                inflight_trials += b
                step_cursor += 1
            if stopping:
                self._save_checkpoint()
                return self.summaries()
        return self.summaries()

    def summaries(self) -> dict:
        return {pt.per: pt.summary() for pt in self.points.values()}


def find_threshold(
    H,
    decoder_factory: Callable[[float], Decoder],
    *,
    target_ler: float = 1e-2,
    lo: float = 1e-4,
    hi: float = 0.2,
    trials_per_probe: int = 2000,
    batch: int = 256,
    seed: int = 0,
    rel_tol: float = 0.05,
    max_probes: int = 12,
) -> dict:
    """Bisect the physical error rate where the decoder's LER crosses
    ``target_ler`` (the practical 'threshold' question for quantum-code
    evaluation; the reference has no analog tool).

    LER(per) is monotone increasing for these channels, so a geometric
    bisection brackets the crossing: each probe runs a single-point
    :class:`FERSweep` (same counted-RNG discipline — a re-run with the
    same seed reproduces the probe stream exactly) and moves the bracket
    endpoint the probe falls on.  Stops when ``hi/lo <= 1 + rel_tol`` or
    after ``max_probes``.

    Returns ``{"threshold": geometric bracket midpoint, "lo": ..,
    "hi": .., "probes": [per-probe summaries]}``.
    """
    if not (0.0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    if not 0.0 < target_ler < 1.0:
        raise ValueError("target_ler must be in (0, 1)")
    probes = []
    for k in range(max_probes):
        if hi / lo <= 1.0 + rel_tol:
            break
        mid = float(np.sqrt(lo * hi))
        sweep = FERSweep(
            H, decoder_factory, [mid], batch=batch, seed=seed + k, multihost=False
        )
        summary = sweep.run(trials_per_point=trials_per_probe)[mid]
        probes.append(summary)
        if summary["ler"] >= target_ler:
            hi = mid
        else:
            lo = mid
    return {
        "threshold": float(np.sqrt(lo * hi)),
        "lo": float(lo),
        "hi": float(hi),
        "target_ler": float(target_ler),
        "probes": probes,
    }


def css_logical_sweep(
    Hx,
    Hz,
    pers: Sequence[float],
    *,
    trials_per_point: int,
    max_iters: int = 100,
    decoder: str = "bposd",
    batch: int = 256,
    seed: int = 0,
    loss_rate: float = 0.0,
    on_device: bool | None = None,
    pipeline: int = 4,
    max_seconds: float | None = None,
    **knobs,
) -> dict:
    """Degeneracy-aware logical-error-rate sweep of a CSS code pair.

    With ``loss_rate > 0`` each shot additionally loses that fraction of
    qubits (heralded erasure shared by both blocks: a lost qubit's X and
    Z components are uniform), and the decoders receive the erasure mask
    via ``CSSDecoder.batch_decode(..., erasures=)`` — prior 0.5 at lost
    positions (requires a prior-capable decoder kind).

    The quantum analog of :class:`FERSweep`: at each physical error rate
    independent X and Z error batches are injected, both stabilizer
    blocks are decoded (`models/css.py::CSSDecoder`), and a lane counts
    as a logical failure when its residual (true XOR estimate) is NOT a
    stabilizer — i.e. lies outside rowspan(Hz) for Z residuals /
    rowspan(Hx) for X — so degenerate corrections are (correctly) not
    failures, unlike exact-recovery LER.

    RNG discipline matches FERSweep: each (point, batch) consumes its own
    counted stream derived from ``(seed, per, step)``, so re-runs
    reproduce exactly.

    Returns ``{per: {"trials", "z_logical_rate", "x_logical_rate",
    "any_logical_rate", *_ci95, "z_converged", "x_converged"}}``.

    Example (gross code):
      >>> from ldpcdecoders_tpu import named_bicycle_code  # doctest: +SKIP
      >>> Hx, Hz, _ = named_bicycle_code("bb144")          # doctest: +SKIP
      >>> css_logical_sweep(Hx, Hz, [0.003], trials_per_point=512)  # doctest: +SKIP
    """
    from .models.css import CSSDecoder

    Hx = np.asarray(Hx) if not hasattr(Hx, "tocsr") else Hx
    Hz = np.asarray(Hz) if not hasattr(Hz, "tocsr") else Hz
    n = Hx.shape[1]
    _prior_capable = ("bp", "bposd", "minsum", "layered_minsum", "bpots",
                      "neural_minsum")
    if (loss_rate == 0.0 and on_device is not False
            and decoder in _prior_capable):
        # perfect-measurement decoding IS the rounds=1 space-time problem
        # (bit-identical inner programs), so the loss-free sweep shares the
        # fully device-resident pipeline: sampling, both block decodes, and
        # the stabilizer-equivalence verdict in one program per batch,
        # `pipeline` batches in flight
        res = spacetime_logical_sweep(
            Hx, Hz, pers, rounds=1, trials_per_point=trials_per_point,
            max_iters=max_iters, decoder=decoder, batch=batch, seed=seed,
            pipeline=pipeline, on_device=on_device,
            max_seconds=max_seconds, **knobs)
        out = {}
        for per, pt in res.items():
            pt = dict(pt)
            pt.pop("rounds", None)
            pt.pop("meas_error_rate", None)
            pt["throughput_pairs_per_s"] = pt.pop("throughput_shots_per_s")
            out[per] = pt
        return out
    out = {}
    # one decoder pair compiled at the first noise point, later points
    # passed as traced prior overrides (FERSweep's shared-program
    # pattern — a fresh CSSDecoder per point would recompile both block
    # programs every time); kinds without override support fall back
    shared = CSSDecoder(Hx, Hz, per=float(pers[0]), max_iters=max_iters,
                        decoder=decoder, **knobs)
    if loss_rate > 0.0 and not (
        shared.x_block.supports_per_override
        and shared.x_block.supports_vector_prior
    ):
        raise ValueError(
            f"loss_rate > 0 needs a prior-capable decoder kind; "
            f"'{decoder}' cannot honor erasure priors"
        )
    per_kw_ok = True
    for per in pers:
        dec = shared
        per_hash = int(per * 1e9) & 0x7FFFFFFF
        trials = zf_cnt = xf_cnt = anyf_cnt = zc_cnt = xc_cnt = 0
        step = 0
        t0 = time.perf_counter()
        while trials < trials_per_point:
            b = min(batch, trials_per_point - trials)
            rng = np.random.default_rng((seed, per_hash, step))
            decode_seed = int(
                np.random.default_rng(
                    (seed, per_hash, step, 0xDEC0DE)
                ).integers(1 << 31)
            )
            if loss_rate > 0.0:
                eps = rng.random((b, n)) < loss_rate
                z_true = np.where(eps, rng.random((b, n)) < 0.5,
                                  sample_errors(rng, b, n, per))
                x_true = np.where(eps, rng.random((b, n)) < 0.5,
                                  sample_errors(rng, b, n, per))
                eps_kw = {"erasures": eps}
            else:
                z_true = sample_errors(rng, b, n, per)
                x_true = sample_errors(rng, b, n, per)
                eps_kw = {}
            syn_x = syndromes_of(Hx, z_true)
            syn_z = syndromes_of(Hz, x_true)
            try:
                if per_kw_ok:
                    z_hat, x_hat, zc, xc = dec.batch_decode(
                        syn_x, syn_z, seed=decode_seed, per=float(per), **eps_kw
                    )
                else:
                    raise ValueError  # route to the per-point decoder
            except ValueError:
                per_kw_ok = False
                if dec is shared and per != pers[0]:
                    dec = CSSDecoder(Hx, Hz, per=float(per),
                                     max_iters=max_iters, decoder=decoder,
                                     **knobs)
                z_hat, x_hat, zc, xc = dec.batch_decode(
                    syn_x, syn_z, seed=decode_seed, **eps_kw
                )
            zf, xf = dec.logical_failures(z_true, z_hat, x_true, x_hat)
            trials += b
            step += 1
            zf_cnt += int(zf.sum())
            xf_cnt += int(xf.sum())
            anyf_cnt += int((zf | xf).sum())
            zc_cnt += int(np.asarray(zc).sum())
            xc_cnt += int(np.asarray(xc).sum())
        dt = time.perf_counter() - t0
        z_lo, z_hi = wilson_interval(zf_cnt, trials)
        x_lo, x_hi = wilson_interval(xf_cnt, trials)
        a_lo, a_hi = wilson_interval(anyf_cnt, trials)
        out[per] = {
            "per": float(per),
            "trials": trials,
            "z_logical_rate": zf_cnt / trials,
            "z_logical_ci95": [z_lo, z_hi],
            "x_logical_rate": xf_cnt / trials,
            "x_logical_ci95": [x_lo, x_hi],
            "any_logical_rate": anyf_cnt / trials,
            "any_logical_ci95": [a_lo, a_hi],
            "z_converged": zc_cnt / trials,
            "x_converged": xc_cnt / trials,
            "throughput_pairs_per_s": trials / dt if dt else 0.0,
        }
    return out


def mixed_fer_sweep(
    H,
    p_flip: float,
    erasure_rates: Sequence[float],
    *,
    trials_per_point: int,
    max_iters: int = 60,
    batch: int = 256,
    seed: int = 0,
    algorithm: str = "minsum",
    strategy: str = "peel+bp",
    osd_order: int | None = None,
    checkpoint_path: str | None = None,
    max_seconds: float | None = None,
    **knobs,
) -> dict:
    """FER sweep over erasure rates on the mixed erasure + bit-flip channel.

    The mixed-channel analog of :class:`FERSweep`: at each erasure rate
    a batch of (erasure mask, error) pairs is injected
    (``utils.noise.sample_mixed_channel``: erased bits uniform, the rest
    flipped with ``p_flip``) and decoded by one shared
    :class:`~ldpcdecoders_tpu.models.mixed.MixedChannelDecoder` — the
    erasure pattern is data, not program, so every point reuses the same
    compiled decode.  RNG discipline matches FERSweep: each (point, step)
    consumes its own counted stream, so re-runs reproduce exactly.

    Returns ``{eps: {"trials", "exact_failure_rate", *_ci95,
    "syndrome_mismatch_rate", "ok_rate", "bp_engaged_steps",
    "mean_peel_rounds", "throughput_decodes_per_s"}}`` —
    ``bp_engaged_steps`` counts decode calls whose cond-gated BP stage
    actually ran (0 for erasure-dominated points that peel clean).

    ``checkpoint_path`` / ``max_seconds`` give FERSweep's crash-safety
    and time budget: counters are saved after every batch, a re-run
    resumes on the exact counted streams (same results as an
    uninterrupted run), and the sweep stops cleanly when the budget is
    spent (returning whatever accumulated).
    """
    from .models.mixed import MixedChannelDecoder

    dec = MixedChannelDecoder(
        H, p_flip, max_iters, algorithm=algorithm, strategy=strategy,
        osd_order=osd_order, **knobs,
    )
    n = dec.n
    _CNT = ("trials", "exact_fail", "smismatch", "not_ok", "bp_steps",
            "rounds_sum", "wall_seconds")
    state = {float(e): dict.fromkeys(_CNT + ("step",), 0) for e in erasure_rates}
    for st in state.values():
        st["wall_seconds"] = 0.0
    if checkpoint_path and os.path.exists(checkpoint_path):
        data = read_json(checkpoint_path)
        if (data.get("seed"), data.get("batch"), data.get("p_flip")) != (
            seed, batch, float(p_flip)
        ):
            raise ValueError(
                "checkpoint was written with a different seed/batch/p_flip config"
            )
        for k, rec in data["points"].items():
            if float(k) in state:
                state[float(k)].update(rec)

    def save():
        if checkpoint_path:
            atomic_write_json(checkpoint_path, {
                "seed": seed, "batch": batch, "p_flip": float(p_flip),
                "points": {str(k): v for k, v in state.items()},
            })

    t_start = time.perf_counter()
    out = {}
    for eps in (float(e) for e in erasure_rates):
        st = state[eps]
        eps_hash = int(eps * 1e9) & 0x7FFFFFFF
        while st["trials"] < trials_per_point:
            if max_seconds is not None and (
                time.perf_counter() - t_start
            ) >= max_seconds:
                break
            b = min(batch, trials_per_point - st["trials"])
            rng = np.random.default_rng((seed, eps_hash, st["step"]))
            erasures, errs = sample_mixed_channel(rng, b, n, p_flip, eps)
            syns = syndromes_of(H, errs)
            t0 = time.perf_counter()
            guesses, ok, peel_rounds, bp_iters = dec.batch_decode_detailed(
                syns, erasures
            )
            st["wall_seconds"] += time.perf_counter() - t0
            exact, smatch = verify_decodes(H, errs, guesses, syns)
            st["trials"] += b
            st["step"] += 1
            st["exact_fail"] += int(b - exact.sum())
            st["smismatch"] += int(b - smatch.sum())
            st["not_ok"] += int(b - ok.sum())
            st["bp_steps"] += int(bp_iters > 0)
            st["rounds_sum"] += int(peel_rounds.sum())
            save()
        trials = st["trials"]
        if not trials:
            continue
        lo, hi = wilson_interval(st["exact_fail"], trials)
        out[eps] = {
            "erasure_rate": eps,
            "p_flip": float(p_flip),
            "trials": trials,
            "exact_failure_rate": st["exact_fail"] / trials,
            "exact_failure_ci95": [lo, hi],
            "syndrome_mismatch_rate": st["smismatch"] / trials,
            "ok_rate": 1.0 - st["not_ok"] / trials,
            "bp_engaged_steps": st["bp_steps"],
            "steps": st["step"],
            "mean_peel_rounds": st["rounds_sum"] / trials,
            "throughput_decodes_per_s": (
                trials / st["wall_seconds"] if st["wall_seconds"] else 0.0
            ),
        }
    return out


def _spacetime_sample(key, Hd, per, q, b: int, R: int):
    """Device-side phenomenological sampler: ``b`` shots of ``R`` noisy
    measurement rounds of the dense ``[m, n]`` block ``Hd``.

    Pure and jittable (also callable eagerly for tests): fresh iid data
    errors at rate ``per`` per round, cumulative error via an int32
    cumsum, syndromes via one exact f32 MXU matmul per history, readout
    flips at rate ``q`` everywhere except the (perfect) final round, and
    the XOR-difference detector record.

    Returns ``(cum_last [b, n] int32, detectors [b, R*m] uint8)``.
    """
    import jax
    import jax.numpy as jnp

    m = Hd.shape[0]
    n = Hd.shape[1]
    ke, ku = jax.random.split(key)
    e = jax.random.bernoulli(ke, per, (b, R, n))
    cum = jnp.cumsum(e.astype(jnp.int32), axis=1) & 1  # [b, R, n]
    syn = jnp.mod(
        cum.reshape(b * R, n).astype(jnp.float32) @ Hd.T, 2.0
    ).astype(jnp.int32).reshape(b, R, m)
    u = jax.random.bernoulli(ku, q, (b, R, m)).astype(jnp.int32)
    u = u.at[:, R - 1].set(0)  # perfect final readout
    syn = syn ^ u
    det = jnp.concatenate([syn[:, :1], syn[:, 1:] ^ syn[:, :-1]], axis=1)
    return cum[:, -1], det.reshape(b, R * m).astype(jnp.uint8)


def _make_spacetime_pair_step(dec_x, dec_z, Hx, Hz, Lx, Lz, b: int):
    """ONE device program for a whole evaluation batch of both blocks:
    sample -> detectors -> decode -> degeneracy-verify -> count.

    The round-2 sweep rebuilt syndromes with per-round host loops and
    reduced residuals through the host bit-packed RREF every batch
    (~200 shots/s on a chip whose FER harness pipelines 90k/s); here the
    entire shot — including the stabilizer-equivalence check, via the
    :func:`~.utils.metrics.css_logical_operators` matmul form — lives on
    device, and only a ``[6]`` int32 count vector is fetched per batch.

    ``per`` / ``q`` / seeds are traced arguments, so one compiled
    program serves every noise point and every step of the sweep.

    Returns a jitted ``step(noise_seed, decode_seed, per, q) ->
    [zfail, xfail, anyfail, zconv, xconv, iters]`` (int32).
    """
    import jax
    import jax.numpy as jnp

    R = dec_x.rounds
    Hxd = jnp.asarray(np.asarray(Hx.todense() if hasattr(Hx, "todense")
                                 else Hx), jnp.float32)
    Hzd = jnp.asarray(np.asarray(Hz.todense() if hasattr(Hz, "todense")
                                 else Hz), jnp.float32)
    Lxd = jnp.asarray(np.asarray(Lx), jnp.float32)
    Lzd = jnp.asarray(np.asarray(Lz), jnp.float32)

    def block(key, dec, Hd, Ld, decode_seed, per, q):
        cum_last, det = _spacetime_sample(key, Hd, per, q, b, R)
        e_hat, conv, iters, _ = dec._decode_batch(det, decode_seed,
                                                  per=per, q=q)
        resid = (cum_last ^ e_hat.astype(jnp.int32)).astype(jnp.float32)
        # residual is a stabilizer iff H @ r == 0 AND L @ r == 0 (mod 2);
        # both products are exact in f32 (row sums far below 2^24)
        fail = jnp.any(jnp.mod(resid @ Hd.T, 2.0) != 0, axis=1)
        if Ld.shape[0]:
            fail = fail | jnp.any(jnp.mod(resid @ Ld.T, 2.0) != 0, axis=1)
        return fail, conv, iters

    def step(noise_seed, decode_seed, per, q):
        kx, kz = jax.random.split(jax.random.PRNGKey(noise_seed))
        zfail, zconv, zit = block(kx, dec_x, Hxd, Lxd, decode_seed, per, q)
        xfail, xconv, xit = block(kz, dec_z, Hzd, Lzd, decode_seed + 1,
                                  per, q)
        return jnp.stack([
            jnp.sum(zfail, dtype=jnp.int32),
            jnp.sum(xfail, dtype=jnp.int32),
            jnp.sum(zfail | xfail, dtype=jnp.int32),
            jnp.sum(zconv, dtype=jnp.int32),
            jnp.sum(xconv, dtype=jnp.int32),
            jnp.sum(zit, dtype=jnp.int32) + jnp.sum(xit, dtype=jnp.int32),
        ])

    return jax.jit(step)


# dense block size above which the device sweep would allocate an
# unreasonable [m, n] f32 operand (falls back to the host loop)
_DEVICE_SWEEP_MAX_DENSE = 50_000_000


def spacetime_logical_sweep(
    Hx,
    Hz,
    pers: Sequence[float],
    *,
    rounds: int,
    trials_per_point: int,
    meas_error_rate: float | None = None,
    max_iters: int = 100,
    decoder: str = "bposd",
    batch: int = 256,
    seed: int = 0,
    pipeline: int = 4,
    on_device: bool | None = None,
    max_seconds: float | None = None,
    **knobs,
) -> dict:
    """Phenomenological-noise logical-error sweep: ``rounds`` noisy
    syndrome-measurement rounds per shot, decoded jointly over the
    space-time detector graph (`models/spacetime.py::SpaceTimeDecoder`).

    Per shot and per stabilizer block, every round injects fresh iid
    data errors at rate ``per`` and flips each readout bit at rate
    ``meas_error_rate`` (default: ``per`` — the standard ``p == q``
    phenomenological convention); the final round is read out perfectly.
    A lane counts as a logical failure when the residual between the
    true cumulative error and the decoder's estimate is outside the
    opposite block's stabilizer rowspan (same degeneracy-aware
    accounting as :func:`css_logical_sweep`).  ``rounds=1`` reproduces
    css_logical_sweep's perfect-measurement setting exactly.

    By default the whole evaluation step — noise sampling, detector
    construction, the joint decode, and the stabilizer-equivalence
    verdict — is ONE jitted device program per batch of shots, with
    ``pipeline`` batches in flight and only a ``[6]`` count vector
    fetched per batch (see :func:`_make_spacetime_pair_step`); noise
    then comes from ``jax.random`` streams keyed by the same
    ``(seed, point, step)`` derivation — statistically equivalent but
    not bitwise comparable with the host-sampled fallback (FERSweep's
    ``sample_on_device`` caveat).  The host loop remains the fallback
    for sparse/oversized blocks, untraceable decoder kinds, and
    ``on_device=False``; for ``decoder="bposd"`` the device path builds
    the inner with ``fused=True`` (identical outputs, traceable).

    RNG discipline matches FERSweep: each (point, batch) consumes its
    own counted stream derived from ``(seed, per, step)``.
    ``max_seconds`` stops cleanly mid-sweep, returning what accumulated.

    Returns ``{per: {"trials", "rounds", "z_logical_rate",
    "x_logical_rate", "any_logical_rate", *_ci95, "z_converged",
    "x_converged", "mean_iters", "throughput_shots_per_s",
    "device_sampled"}}``.
    """
    from .models.spacetime import SpaceTimeDecoder

    R = int(rounds)
    dense_ok = (Hx.shape[0] * Hx.shape[1] + Hz.shape[0] * Hz.shape[1]
                <= _DEVICE_SWEEP_MAX_DENSE)
    use_dev = dense_ok if on_device is None else bool(on_device)
    dec_kw = dict(meas_error_rate=meas_error_rate, decoder=decoder, **knobs)
    if (use_dev and decoder == "bposd" and "fused" not in knobs
            and knobs.get("osd_impl", "device") != "host"):
        # the compacting OSD path gathers failing lanes on host (never
        # traceable); the fused cond-gated program is output-identical
        dec_kw["fused"] = True
    dec_x = SpaceTimeDecoder(Hx, R, float(pers[0]), max_iters, **dec_kw)
    dec_z = SpaceTimeDecoder(Hz, R, float(pers[0]), max_iters, **dec_kw)
    dev_steps: dict[int, Callable] = {}
    if use_dev:
        from .cache import ensure_default_cache
        from .utils.metrics import css_logical_operators

        ensure_default_cache()
        Lx = css_logical_operators(Hx, Hz)  # Z residuals vs rowspan(Hz)
        Lz = css_logical_operators(Hz, Hx)

        def dev_step_for(b):
            if b not in dev_steps:
                dev_steps[b] = _make_spacetime_pair_step(
                    dec_x, dec_z, Hx, Hz, Lx, Lz, b)
            return dev_steps[b]
    else:
        from .utils.metrics import gf2_rowspan_reducer

        z_span = gf2_rowspan_reducer(Hz)  # Z residuals must be Z stabilizers
        x_span = gf2_rowspan_reducer(Hx)
    n = dec_x.block_n
    depth = max(1, int(pipeline)) if use_dev else 1
    t_start = time.perf_counter()
    out = {}
    for per in pers:
        q = float(per) if meas_error_rate is None else float(meas_error_rate)
        per_hash = int(per * 1e9) & 0x7FFFFFFF
        trials = zf = xf = anyf = zc = xc = iters_sum = 0
        step = 0
        inflight: list = []  # (counts_device_array, b)
        t0 = time.perf_counter()

        def finalize_one():
            nonlocal trials, zf, xf, anyf, zc, xc, iters_sum, inflight_trials
            v, b = inflight.pop(0)
            v = np.asarray(v)
            trials += b
            inflight_trials -= b
            zf += int(v[0])
            xf += int(v[1])
            anyf += int(v[2])
            zc += int(v[3])
            xc += int(v[4])
            iters_sum += int(v[5])

        inflight_trials = 0
        stopping = False
        while trials + inflight_trials < trials_per_point or inflight:
            if max_seconds is not None and not stopping and (
                    time.perf_counter() - t_start) >= max_seconds:
                stopping = True
            if stopping and not inflight:
                break
            want_more = (not stopping
                         and trials + inflight_trials < trials_per_point)
            if not want_more or len(inflight) >= depth:
                finalize_one()
                continue
            b = min(batch, trials_per_point - trials - inflight_trials)
            rng = np.random.default_rng((seed, per_hash, step))
            decode_seed = int(np.random.default_rng(
                (seed, per_hash, step, 0xDEC0DE)).integers(1 << 31))
            if use_dev:
                noise_seed = int(np.random.default_rng(
                    (seed, per_hash, step, 0x5A3D)).integers(1 << 31))
                try:
                    counts = dev_step_for(b)(noise_seed, decode_seed,
                                             float(per), q)
                except Exception:
                    # untraceable decoder kind: permanent host fallback
                    use_dev = False
                    depth = 1
                    from .utils.metrics import gf2_rowspan_reducer

                    z_span = gf2_rowspan_reducer(Hz)
                    x_span = gf2_rowspan_reducer(Hx)
            if not use_dev:
                counts = _spacetime_host_step(
                    dec_x, dec_z, Hx, Hz, z_span, x_span, rng, decode_seed,
                    b, R, n, float(per), q)
            inflight.append((counts, b))
            inflight_trials += b
            step += 1
        dt = time.perf_counter() - t0
        if not trials:
            continue
        z_lo, z_hi = wilson_interval(zf, trials)
        x_lo, x_hi = wilson_interval(xf, trials)
        a_lo, a_hi = wilson_interval(anyf, trials)
        out[per] = {
            "per": float(per),
            "meas_error_rate": q,
            "rounds": R,
            "trials": trials,
            "z_logical_rate": zf / trials,
            "z_logical_ci95": [z_lo, z_hi],
            "x_logical_rate": xf / trials,
            "x_logical_ci95": [x_lo, x_hi],
            "any_logical_rate": anyf / trials,
            "any_logical_ci95": [a_lo, a_hi],
            "z_converged": zc / trials,
            "x_converged": xc / trials,
            "mean_iters": iters_sum / (2 * trials),
            "throughput_shots_per_s": trials / dt if dt else 0.0,
            "device_sampled": bool(use_dev),
        }
        if stopping:
            break
    return out


def _spacetime_host_step(dec_x, dec_z, Hx, Hz, z_span, x_span, rng,
                         decode_seed, b, R, n, per, q):
    """Host-sampled fallback batch (NumPy counted streams — the original
    round-2 loop, kept for sparse/oversized blocks and untraceable
    decoder kinds).  Returns the same [6] counts as the device step."""
    from .codes.spacetime import detectors_of

    def run(dec, H_det, span, s_off):
        # fresh errors per round -> cumulative -> noisy syndromes
        e = sample_errors(rng, b * R, n, per).reshape(b, R, n)
        cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
        syn = np.stack([syndromes_of(H_det, cum[:, r]) for r in range(R)],
                       axis=1)
        u = sample_errors(rng, b * R, dec.block_m, q).reshape(
            b, R, dec.block_m)
        u[:, -1] = 0  # perfect final readout
        syn ^= u.astype(np.uint8)
        det = detectors_of(syn)
        e_hat, conv, iters, _, _ = dec.batch_decode_detailed(
            det, seed=decode_seed + s_off, per=per, q=q)
        resid = cum[:, -1] ^ np.asarray(e_hat).astype(np.uint8)
        return ~span(resid), np.asarray(conv), int(np.asarray(iters).sum())

    zfail, zconv, zit = run(dec_x, Hx, z_span, 0)  # Hx detects Z errors
    xfail, xconv, xit = run(dec_z, Hz, x_span, 1)
    return np.array([zfail.sum(), xfail.sum(), (zfail | xfail).sum(),
                     zconv.sum(), xconv.sum(), zit + xit], np.int64)


def dem_logical_sweep(
    dem,
    *,
    shots: int = 100_000,
    max_iters: int = 60,
    decoder: str = "bposd",
    batch: int = 2048,
    seed: int = 0,
    rounds: int | None = None,
    pipeline: int = 4,
    on_device: bool | None = None,
    circuit=None,
    max_seconds: float | None = None,
    **knobs,
) -> dict:
    """Observable-prediction error rate of a detector error model —
    the sinter-style evaluation for circuit-level decoding.

    ``dem`` is a flattened-or-not DEM path/text, a ``(A, priors, O)``
    triple, or a ready :class:`~.models.detector.DetectorGraphDecoder`.
    By default each evaluation batch is ONE jitted device program
    (the same discipline as :func:`spacetime_logical_sweep`): sample a
    mechanism vector per lane from the DEM priors with ``jax.random``,
    build the detector records with one MXU matmul, decode, project
    both the true and the predicted observable flips, and fetch only a
    ``[2]`` count vector, ``pipeline`` batches in flight.

    With ``circuit=`` (a :class:`~.codes.circuit.StabilizerCircuit`),
    shots are instead drawn from the CIRCUIT by host Pauli-frame
    sampling (:func:`~.codes.circuit.sample_circuit`) and only the
    decode runs on device — the model-independent ground truth (the
    DEM-sampled and circuit-sampled rates must agree, since both are
    XORs of the same independent mechanisms; tested in
    tests/test_circuit.py).

    ``rounds`` is metadata: when given, the summary adds the
    standard per-round rate ``1 - (1 - LER)^(1/rounds)``.

    Returns ``{"shots", "fails", "logical_rate", "logical_ci95",
    "per_round_rate"?, "converged", "throughput_shots_per_s",
    "device_sampled"}``.
    """
    from .models.detector import DetectorGraphDecoder, load_dem
    from .models.staged import StagedDemDecoder

    if isinstance(dem, StagedDemDecoder) or decoder == "staged":
        # the staged production path (stage0 + deep ensemble + native
        # OSD) carries its own pipelined device-resident evaluator
        if isinstance(dem, StagedDemDecoder):
            sdec = dem
        else:
            if isinstance(dem, tuple):
                A, priors, O = dem
            else:
                A, priors, O = load_dem(dem)
            knobs.setdefault("stage0_iters", min(max_iters, 96))
            knobs.setdefault("deep_iters", max_iters)
            osd_order = knobs.pop("osd_order", 0)
            if osd_order:  # CLI/bposd-style knob: the OSD-CS pair depth
                knobs.setdefault("lam", osd_order)
            sdec = StagedDemDecoder(A, priors, observables=O, **knobs)
        if circuit is not None:
            # circuit-sampled ground truth: host sampling, staged decode
            from .codes.circuit import sample_circuit

            det, obs = sample_circuit(circuit, shots, seed=seed)
            t0 = time.perf_counter()
            fails = convd = done = 0
            while done < shots:
                d = det[done: done + batch]
                o = obs[done: done + batch]
                pred, conv = sdec.predict_observables(d, seed=seed + done)
                fails += int((pred != o).any(axis=1).sum())
                convd += int(np.asarray(conv).sum())
                done += len(d)
            dt = time.perf_counter() - t0
            lo, hi = wilson_interval(fails, done)
            out = {"shots": done, "fails": fails,
                   "logical_rate": fails / done,
                   "logical_ci95": [lo, hi], "converged": convd / done,
                   "throughput_shots_per_s": done / dt if dt else 0.0,
                   "device_sampled": False}
        else:
            out = sdec.run_eval(shots, batch=batch, seed=seed,
                                pipeline=pipeline,
                                max_seconds=max_seconds)
        if rounds and out.get("shots"):
            out["rounds"] = int(rounds)
            out["per_round_rate"] = 1.0 - (
                1.0 - out["logical_rate"]) ** (1.0 / rounds)
        return out

    if isinstance(dem, DetectorGraphDecoder):
        dec = dem
    else:
        dec_kw = dict(knobs)
        if (decoder == "bposd" and "fused" not in dec_kw
                and dec_kw.get("osd_impl", "device") != "host"):
            dec_kw["fused"] = True  # traceable, output-identical
        if isinstance(dem, tuple):
            A, priors, O = dem
            dec = DetectorGraphDecoder(A, priors, max_iters, observables=O,
                                       decoder=decoder, **dec_kw)
        else:
            dec = DetectorGraphDecoder.from_dem(dem, max_iters,
                                                decoder=decoder, **dec_kw)
    if dec.O is None or dec.O.shape[0] == 0:
        raise ValueError("the model declares no logical observables")

    use_dev = circuit is None if on_device is None else bool(on_device)
    if circuit is not None and use_dev:
        raise ValueError("circuit sampling is host-side; pass "
                         "on_device=False or drop it")

    import jax
    import jax.numpy as jnp

    from .cache import ensure_default_cache

    ensure_default_cache()
    A_dense = np.asarray(dec.A.todense())  # hoisted: host batches reuse it
    if use_dev:  # device constants only when a device step will run
        Ad = jnp.asarray(A_dense, jnp.float32)
        Od = jnp.asarray(dec.O, jnp.float32)
        prior = jnp.asarray(dec._prior, jnp.float32)

    def make_step(b):
        def step(noise_seed, decode_seed):
            x = jax.random.bernoulli(
                jax.random.PRNGKey(noise_seed), prior, (b, dec.N))
            xf = x.astype(jnp.float32)
            det = jnp.mod(xf @ Ad.T, 2.0).astype(jnp.uint8)
            x_hat, conv, _, _ = dec._decode_batch(det, decode_seed)
            diff = (xf + x_hat.astype(jnp.float32)) @ Od.T
            fail = jnp.any(jnp.mod(diff, 2.0) != 0, axis=1)
            return jnp.stack([jnp.sum(fail, dtype=jnp.int32),
                              jnp.sum(conv, dtype=jnp.int32)])

        return jax.jit(step)

    steps: dict[int, Callable] = {}
    circ_det = circ_obs = None
    if circuit is not None:
        from .codes.circuit import sample_circuit

        circ_det, circ_obs = sample_circuit(circuit, shots, seed=seed)

    trials = fails = convd = 0
    inflight: list = []
    inflight_trials = 0
    step_i = 0
    depth = max(1, int(pipeline)) if use_dev else 1
    stopping = False
    t0 = time.perf_counter()

    def finalize_one():
        nonlocal trials, fails, convd, inflight_trials
        item, b = inflight.pop(0)
        if isinstance(item, tuple):  # host batch (fallback can mix modes)
            f, c = item
        else:
            f, c = np.asarray(item)
        fails += int(f)
        convd += int(c)
        trials += b
        inflight_trials -= b

    while trials + inflight_trials < shots or inflight:
        if max_seconds is not None and not stopping and (
                time.perf_counter() - t0) >= max_seconds:
            stopping = True
        if stopping and not inflight:
            break
        want_more = not stopping and trials + inflight_trials < shots
        if not want_more or len(inflight) >= depth:
            finalize_one()
            continue
        b = min(batch, shots - trials - inflight_trials)
        rng = np.random.default_rng((seed, step_i))
        decode_seed = int(rng.integers(1 << 31))
        if use_dev:
            noise_seed = int(rng.integers(1 << 31))
            try:
                if b not in steps:
                    steps[b] = make_step(b)
                item = steps[b](noise_seed, decode_seed)
            except Exception:
                use_dev = False  # untraceable inner: host fallback
                depth = 1
        if not use_dev:
            lo = trials + inflight_trials
            if circuit is not None:
                det = circ_det[lo: lo + b]
                obs = circ_obs[lo: lo + b]
            else:
                x = (rng.random((b, dec.N)) < dec._prior).astype(np.uint8)
                det = (x @ A_dense.T) & 1
                obs = (x @ dec.O.T) & 1
            pred, conv = dec.predict_observables(det, seed=decode_seed)
            item = (int((pred != obs).any(axis=1).sum()),
                    int(np.asarray(conv).sum()))
        inflight.append((item, b))
        inflight_trials += b
        step_i += 1
    dt = time.perf_counter() - t0
    if not trials:
        return {"shots": 0}
    lo, hi = wilson_interval(fails, trials)
    out = {
        "shots": trials,
        "fails": fails,
        "logical_rate": fails / trials,
        "logical_ci95": [lo, hi],
        "converged": convd / trials,
        "throughput_shots_per_s": trials / dt if dt else 0.0,
        "device_sampled": bool(use_dev),
    }
    if rounds:
        out["rounds"] = int(rounds)
        out["per_round_rate"] = 1.0 - (1.0 - out["logical_rate"]) ** (
            1.0 / rounds)
    return out
