"""Frozen decoder configurations (SURVEY.md §5 config-system plan).

The reference configures decoders purely through constructor arguments;
this module adds a serializable frozen dataclass carrying the same knobs
plus this framework's own, so services and sweep jobs can persist and
rebuild decoders from JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = ["DecoderConfig"]

_KINDS = (
    "bp",
    "bposd",
    "bitflip",
    "bpots",
    "minsum",
    "minsum_int8",
    "layered_minsum",
    "qc_minsum",
    "neural_minsum",
    # quantum wrapper kinds (SpaceTime / SlidingWindow / DetectorGraph)
    "spacetime",
    "window",
    "detector",
    "ensemble",
    "staged",
)

#: decoder-specific knobs forwarded from a wrapper kind's config to its
#: inner decoder's DecoderConfig
_INNER_KNOBS = ("osd_order", "T", "C", "alpha", "beta", "scale", "beta_q",
                "fused", "osd_scope", "osd_method",
                "osd_impl", "inner", "damping")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Everything needed to build a decoder, minus the code itself.

    Example:
      >>> cfg = DecoderConfig(kind="bp", per=0.01, max_iters=50)
      >>> DecoderConfig.from_json(cfg.to_json()) == cfg
      True
    """

    kind: str
    per: float = 0.01
    max_iters: int = 100
    # decoder-specific knobs (ignored where not applicable)
    osd_order: int = 0
    T: int = 9
    C: float = 2.0
    # None = each decoder's own default (1.0 flooding, 0.8 layered)
    alpha: float | None = None
    beta: float = 0.0
    scale: float = 4.0
    beta_q: int = 1
    #: BP+OSD only: compile BP + cond-gated OSD into one device program
    fused: bool = False
    #: BP+OSD only: "all" (reference semantics) or "failed" (OSD-w on
    #: failing lanes only — throughput deviation)
    osd_scope: str = "all"
    #: BP+OSD only: "exhaustive" (reference 2^w sweep) or
    #: "combination_sweep" (OSD-CS: singles + pairs within osd_order)
    osd_method: str = "exhaustive"
    #: BP+OSD only: "device" (XLA or Pallas elimination) or "host" (the
    #: threaded C++ column-reduction eliminator — for detector models
    #: too wide for the device paths; OSD-0, untraceable)
    osd_impl: str = "device"
    #: BP+OSD only: inner soft-output decoder — None/"sumproduct"
    #: (reference semantics) or "minsum" (far more robust on degenerate
    #: circuit-level detector graphs — measured 0.61 vs 0.05 converged
    #: on the bb144 circuit DEM)
    inner: str | None = None
    #: minsum family: message damping in [0, 1) (loopy-graph stabilizer)
    damping: float = 0.0
    #: qc_minsum only: 'flooding' or 'layered' (conflict-free check layers)
    schedule: str = "flooding"
    #: qc_minsum only: 'minsum' or 'sumproduct' (exact tanh-rule BP)
    algorithm: str = "minsum"
    #: neural_minsum only: npz schedule saved by
    #: NeuralMinSumDecoder.save_schedule (None = untrained = plain min-sum)
    schedule_path: str | None = None
    #: spacetime/window/detector only: inner decoder kind (any
    #: prior-capable kind above)
    inner_kind: str = "bposd"
    #: spacetime/window only: measurement rounds decoded jointly
    rounds: int = 1
    #: spacetime/window only: readout flip rate (None = per, the p == q
    #: phenomenological convention)
    meas_error_rate: float | None = None
    #: spacetime only: final round read out perfectly (closed problem)
    perfect_last: bool = True
    #: window only: rounds per decoded window / rounds committed per slide
    window: int = 3
    commit: int = 1
    #: detector only: flattened DEM file to build from (``build(None)``);
    #: alternatively pass ``build((A, priors[, observables]))``
    dem_path: str | None = None
    #: ensemble only: member configs (dicts or DecoderConfig instances,
    #: normalized to dicts so the whole thing JSON round-trips); the
    #: built EnsembleDecoder picks the max-likelihood syndrome-
    #: consistent candidate per shot
    members: tuple = ()
    #: staged only (models/staged.py): ensemble damping members — each a
    #: scalar or a [lo, hi] disordered-memory range; plus the stage-0
    #: iteration cap, relay restarts, and OSD-CS depths (lam pairs /
    #: lam3 triples).  max_iters is the deep (straggler) cap.
    gammas: tuple = (0.4,)
    stage0_iters: int = 96
    relay_legs: int = 0
    lam: int = 40
    lam3: int = 0
    #: staged only: deep-member message dtype, "f32" (default) or
    #: "bf16" — measured 1.56x faster at equal-or-better solve rate on
    #: bb144 (round 5); a string so configs JSON round-trip
    deep_dtype: str | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown decoder kind '{self.kind}' (choose from {_KINDS})")
        # canonical form: JSON round-trips lists; gammas holds scalars
        # and/or (lo, hi) dmem ranges
        object.__setattr__(
            self, "gammas",
            tuple(tuple(float(x) for x in g)
                  if isinstance(g, (list, tuple)) else float(g)
                  for g in self.gammas))
        if (self.kind in ("spacetime", "window", "detector")
                and self.inner_kind in ("spacetime", "window", "detector")):
            raise ValueError(
                f"inner_kind '{self.inner_kind}' cannot itself be a wrapper "
                "kind; pick a base decoder (bp, bposd, minsum, ...)")
        if self.kind == "ensemble":
            if not self.members:
                raise ValueError("kind='ensemble' needs at least one member")
            norm = []
            for mcfg in self.members:
                d = (dataclasses.asdict(mcfg)
                     if isinstance(mcfg, DecoderConfig)
                     else dict(mcfg))
                if d.get("kind") in ("ensemble",):
                    raise ValueError("ensembles cannot nest ensembles")
                # a member's own (necessarily empty) members field would
                # round-trip tuple -> JSON list; drop it for canonical form
                if not d.pop("members", None) in (None, (), []):
                    raise ValueError("ensembles cannot nest ensembles")
                # validate AND canonicalize member fields (e.g. gammas
                # lists -> tuples) so dict equality survives JSON
                d = dataclasses.asdict(DecoderConfig.from_dict(d))
                d.pop("members", None)
                norm.append(d)
            object.__setattr__(self, "members", tuple(norm))
        elif self.members:
            raise ValueError("members is an ensemble-only field")
        else:
            # canonical empty form: JSON round-trips () as [], so pin ()
            object.__setattr__(self, "members", ())

    def build(self, H):
        """Construct the decoder for parity-check matrix ``H``.

        For ``kind='qc_minsum'`` pass the code as ``(base, Z)`` (the QC
        base matrix and lift size) instead of a lifted H — the decoder
        needs the circulant structure, which a flat matrix loses.
        """
        import ldpcdecoders_tpu as lt

        k = self.kind
        if k == "ensemble":
            from .models.ensemble import EnsembleDecoder

            built = [DecoderConfig.from_dict(d).build(H)
                     for d in self.members]
            H_arr = H if (hasattr(H, "todense") or (
                hasattr(H, "ndim") and getattr(H, "ndim", 0) == 2)) else None
            return EnsembleDecoder(built, H=H_arr)
        if k in ("spacetime", "window", "detector"):
            knobs = {f: getattr(self, f) for f in _INNER_KNOBS}
            if k == "spacetime":
                return lt.SpaceTimeDecoder(
                    H, self.rounds, self.per, self.max_iters,
                    meas_error_rate=self.meas_error_rate,
                    decoder=self.inner_kind,
                    perfect_last=self.perfect_last, **knobs)
            if k == "window":
                return lt.SlidingWindowDecoder(
                    H, self.per, self.max_iters, window=self.window,
                    commit=self.commit,
                    meas_error_rate=self.meas_error_rate,
                    decoder=self.inner_kind, **knobs)
            if self.dem_path:
                return lt.DetectorGraphDecoder.from_dem(
                    self.dem_path, self.max_iters, decoder=self.inner_kind,
                    **knobs)
            if not (isinstance(H, tuple) and len(H) in (2, 3)):
                raise ValueError(
                    "kind='detector' takes (A, priors) or (A, priors, "
                    "observables) as the code argument, or set dem_path")
            A, priors, *rest = H
            return lt.DetectorGraphDecoder(
                A, priors, self.max_iters,
                observables=rest[0] if rest else None,
                decoder=self.inner_kind, **knobs)
        if k == "staged":
            from .models.staged import StagedDemDecoder

            if not (isinstance(H, tuple) and len(H) in (2, 3)):
                raise ValueError(
                    "kind='staged' takes (A, priors) or (A, priors, "
                    "observables) as the code argument")
            A, priors, *rest = H
            gammas = tuple(tuple(g) if isinstance(g, (list, tuple)) else g
                           for g in self.gammas)
            deep_dtype = None
            if self.deep_dtype is not None:
                import jax.numpy as jnp

                if self.deep_dtype not in ("f32", "bf16"):
                    raise ValueError(
                        f"deep_dtype must be 'f32' or 'bf16', got "
                        f"{self.deep_dtype!r}")
                deep_dtype = (jnp.bfloat16 if self.deep_dtype == "bf16"
                              else jnp.float32)
            return StagedDemDecoder(
                A, priors, observables=rest[0] if rest else None,
                gammas=gammas, stage0_iters=self.stage0_iters,
                deep_iters=self.max_iters, lam=self.lam, lam3=self.lam3,
                relay_legs=self.relay_legs, deep_dtype=deep_dtype)
        if k == "qc_minsum":
            if not (isinstance(H, tuple) and len(H) == 2):
                raise ValueError(
                    "kind='qc_minsum' takes the code as a (base, Z) tuple, "
                    "not a lifted parity-check matrix"
                )
            base, Z = H
            return lt.QCMinSumDecoder(
                base, Z, self.per, self.max_iters,
                alpha=self.alpha, beta=self.beta, schedule=self.schedule,
                algorithm=self.algorithm,
            )
        if k == "bp":
            return lt.BeliefPropagationDecoder(H, self.per, self.max_iters)
        if k == "bposd":
            return lt.BeliefPropagationOSDDecoder(
                H, self.per, self.max_iters, osd_order=self.osd_order,
                fused=self.fused, osd_scope=self.osd_scope,
                osd_method=self.osd_method, osd_impl=self.osd_impl,
                inner=self.inner,
                damping=self.damping,
            )
        if k == "bitflip":
            return lt.BitFlipDecoder(H, self.per, self.max_iters)
        if k == "bpots":
            return lt.BPOTSDecoder(H, self.per, self.max_iters, T=self.T, C=self.C)
        if k == "minsum":
            return lt.MinSumDecoder(
                H, self.per, self.max_iters, damping=self.damping,
                alpha=1.0 if self.alpha is None else self.alpha,
                beta=self.beta,
            )
        if k == "minsum_int8":
            return lt.QuantizedMinSumDecoder(
                H, self.per, self.max_iters, scale=self.scale, beta_q=self.beta_q
            )
        if k == "neural_minsum":
            dec = lt.NeuralMinSumDecoder(H, self.per, self.max_iters)
            if self.schedule_path:
                dec.load_schedule(self.schedule_path)
            return dec
        if k == "layered_minsum":
            return lt.LayeredMinSumDecoder(
                H, self.per, self.max_iters, damping=self.damping,
                alpha=0.8 if self.alpha is None else self.alpha,
                beta=self.beta,
            )
        raise AssertionError(k)

    # -- serialization ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "DecoderConfig":
        return DecoderConfig(**json.loads(s))

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DecoderConfig":
        return DecoderConfig(**d)
