"""Sliding-window streaming decoding of unbounded syndrome streams.

A real-time decoder cannot wait for a run's final (perfect) readout:
it must emit corrections while measurement rounds keep arriving.  The
standard construction decodes a *window* of ``W`` rounds over the
open-boundary space-time graph (``codes/spacetime.py`` with
``perfect_last=False`` — the window's last rounds may still be
explained by future measurement errors), *commits* only the oldest
``C`` rounds of its solution (the part no future data can change
much), slides forward by ``C``, and repeats; the stream's final window
uses the closed graph.

Cross-window bookkeeping is one XOR: committing round ``t``'s
measurement-error estimate ``u_t`` removes its contribution from the
next window's first detector (``d_{t+1} = H e_{t+1} + u_{t+1} + u_t``),
so each window decodes an *adjusted* detector slice and the whole
stream telescopes — the final cumulative estimate exactly reproduces
the final perfect syndrome (tested), just like a full-history decode.

Streaming notes: every mid-stream window is ONE jitted program
(decode + commit-XOR + carry extraction fused); the ``[B, m]`` carry
mask, the accumulated correction ``E``, and the convergence tally all
stay device-resident between windows, so a whole stream dispatches
with NO device->host transfer until the final fetch — window ``k+1``
is enqueued while ``k`` is still decoding (XLA async dispatch), which
is what makes the decoder real-time rather than sync-per-window (the
round-2 loop fetched ``conv`` to host between windows).  Only the
final closed window compiles a second program per distinct tail
length.  Decoder kinds whose ``_decode_batch`` doesn't trace fall back
to an eager host loop with identical outputs; for the default
``bposd`` the inner is built ``fused=True`` (output-identical, and the
cond-gated OSD keeps the common all-converged window at plain-BP
cost).
"""

from __future__ import annotations

import numpy as np

from ..codes.spacetime import detectors_of
from .spacetime import SpaceTimeDecoder

__all__ = ["SlidingWindowDecoder"]


class SlidingWindowDecoder:
    """Streaming decoder: window ``W`` rounds, commit ``C``, slide.

    Args:
      H: ``[m, n]`` stabilizer block.
      per: per-round data-error rate (scalar or ``[n]``).
      max_iters: BP iteration cap per window decode.
      window: rounds per decoded window ``W >= 2``.
      commit: rounds committed (and slid past) per window,
        ``1 <= commit < window``.  Smaller = more overlap = better
        accuracy, more decodes per round.
      meas_error_rate: readout flip rate (default ``per``).
      decoder: inner decoder kind (prior-capable; "bposd" default).
      **knobs: extra DecoderConfig fields.
    """

    def __init__(self, H, per, max_iters: int, *, window: int = 3,
                 commit: int = 1, meas_error_rate=None,
                 decoder: str = "bposd", **knobs):
        W, C = int(window), int(commit)
        if W < 2:
            raise ValueError(f"window must be >= 2 rounds, got {window}")
        if not 1 <= C < W:
            raise ValueError(
                f"commit must be in [1, window), got {commit} (window={window})")
        self.window, self.commit = W, C
        if (decoder == "bposd" and "fused" not in knobs
                and knobs.get("osd_impl", "device") != "host"):
            # the compacting OSD-0 path syncs to host per window; the
            # fused cond-gated program is output-identical and traceable
            knobs = dict(knobs, fused=True)
        self._mk = dict(per=per, max_iters=max_iters,
                        meas_error_rate=meas_error_rate, decoder=decoder,
                        **knobs)
        # one open-boundary decoder serves every mid-stream window;
        # closed tail decoders are built lazily per distinct tail length
        self._open = SpaceTimeDecoder(H, W, per, max_iters,
                                      meas_error_rate=meas_error_rate,
                                      decoder=decoder, perfect_last=False,
                                      **knobs)
        self._closed: dict[int, SpaceTimeDecoder] = {}
        self._H = self._open.A  # keep a reference alive (sparse)
        # per-round block shapes (NOT the open decoder's R*m record length)
        self.m, self.n = self._open.block_m, self._open.block_n
        self._Hs = H
        self._mid_step = None  # jitted mid-stream window program
        self._tail_steps: dict[int, object] = {}
        self._jit_ok = True  # latches False if the inner doesn't trace

    def _tail(self, rounds: int) -> SpaceTimeDecoder:
        if rounds not in self._closed:
            self._closed[rounds] = SpaceTimeDecoder(
                self._Hs, rounds, self._mk["per"], self._mk["max_iters"],
                meas_error_rate=self._mk["meas_error_rate"],
                decoder=self._mk["decoder"], perfect_last=True,
                **{k: v for k, v in self._mk.items()
                   if k not in ("per", "max_iters", "meas_error_rate",
                                "decoder")})
        return self._closed[rounds]

    # -- device-chained streaming steps -------------------------------------

    def _make_mid_step(self):
        import jax
        import jax.numpy as jnp

        W, C, m = self.window, self.commit, self.m
        dec = self._open

        def step(win, carry, E, conv_sum, seed):
            # win: [B, W, m] detector slice; carry: [B, m] committed u
            win = win.astype(jnp.int32)
            win = win.at[:, 0].set(win[:, 0] ^ carry)
            B = win.shape[0]
            _, conv, _, aux = dec._decode_batch(
                win.reshape(B, W * m).astype(jnp.uint8), seed)
            data = aux["data_rounds"].astype(jnp.int32)
            meas = aux["meas"].astype(jnp.int32)
            E = E ^ (jnp.sum(data[:, :C], axis=1) & 1)
            carry = meas[:, C - 1] & 1
            return E, carry, conv_sum + jnp.mean(conv.astype(jnp.float32))

        return jax.jit(step)

    def _make_tail_step(self, rem: int):
        import jax
        import jax.numpy as jnp

        m = self.m
        dec = self._tail(rem)

        def step(win, carry, E, conv_sum, seed):
            win = win.astype(jnp.int32)
            win = win.at[:, 0].set(win[:, 0] ^ carry)
            B = win.shape[0]
            e_tail, conv, _, _ = dec._decode_batch(
                win.reshape(B, rem * m).astype(jnp.uint8), seed)
            E = (E ^ e_tail.astype(jnp.int32)).astype(jnp.int8)
            return E, conv_sum + jnp.mean(conv.astype(jnp.float32))

        return jax.jit(step)

    # -- public API ----------------------------------------------------------

    def decode_stream(self, syndromes, *, seed: int = 0):
        """Decode a full measured stream ``[B, R, m]`` (last round
        perfect) by sliding windows; returns
        ``(errors [B, n] int8, info dict)`` where ``errors`` is the
        cumulative data correction after round ``R`` and ``info`` has
        ``windows`` (decode count) and ``converged`` (fraction of
        window decodes whose BP converged, averaged over lanes)."""
        s = np.asarray(syndromes).astype(np.uint8)
        if s.ndim != 3 or s.shape[2] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, R, {self.m}], got {s.shape}")
        return self.decode_detector_stream(detectors_of(s).reshape(s.shape),
                                           seed=seed)

    def decode_detector_stream(self, detectors, *, seed: int = 0):
        """Like :meth:`decode_stream` but on a precomputed detector
        record ``[B, R, m]`` (``detectors_of`` of the syndrome history,
        reshaped round-major)."""
        d = np.asarray(detectors).astype(np.uint8)
        if d.ndim != 3 or d.shape[2] != self.m:
            raise ValueError(
                f"expected detectors of shape [B, R, {self.m}], got {d.shape}")
        if self._jit_ok:
            import jax

            try:
                return self._decode_stream_device(d, seed)
            except (TypeError, jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError,
                    jax.errors.TracerBoolConversionError):
                # untraceable inner decoder: latch the eager fallback.
                # Runtime errors (OOM, shape bugs) propagate — silently
                # demoting every future stream to the host loop would
                # hide them.
                self._jit_ok = False
        return self._decode_stream_host(d, seed)

    def _decode_stream_device(self, d, seed: int):
        """Whole-stream device chain: all windows dispatched without a
        host sync; one fetch at the end."""
        import jax.numpy as jnp

        B, R, m = d.shape
        W, C = self.window, self.commit
        if self._mid_step is None:
            self._mid_step = self._make_mid_step()
        E = jnp.zeros((B, self.n), jnp.int32)
        carry = jnp.zeros((B, m), jnp.int32)
        conv_sum = jnp.float32(0.0)
        t = 0
        n_windows = 0
        step = 0
        while R - t > W:
            E, carry, conv_sum = self._mid_step(
                d[:, t: t + W], carry, E, conv_sum, seed + step)
            t += C
            n_windows += 1
            step += 1
        rem = R - t
        if rem not in self._tail_steps:
            self._tail_steps[rem] = self._make_tail_step(rem)
        E, conv_sum = self._tail_steps[rem](
            d[:, t:], carry, E, conv_sum, seed + step)
        n_windows += 1
        return np.asarray(E).astype(np.int8), {
            "windows": n_windows,
            "converged": float(np.asarray(conv_sum)) / n_windows,
            "rounds": R,
        }

    def _decode_stream_host(self, d, seed: int):
        """Eager fallback (identical outputs): for inner decoder kinds
        with host-side orchestration that cannot trace."""
        B, R, m = d.shape
        W, C = self.window, self.commit
        E = np.zeros((B, self.n), np.uint8)
        carry = np.zeros((B, m), np.uint8)  # committed u of the last round
        t = 0
        n_windows = 0
        conv_sum = 0.0
        step = 0
        while R - t > W:
            win = d[:, t: t + W].copy()
            win[:, 0] ^= carry
            _, conv, _, aux, _ = self._open.batch_decode_detailed(
                win.reshape(B, W * m), seed=seed + step)
            data = np.asarray(aux["data_rounds"])
            meas = np.asarray(aux["meas"])
            E ^= (data[:, :C].astype(np.uint8).sum(axis=1) & 1)
            carry = meas[:, C - 1].astype(np.uint8)
            t += C
            n_windows += 1
            conv_sum += float(np.asarray(conv).mean())
            step += 1
        rem = R - t
        win = d[:, t:].copy()
        win[:, 0] ^= carry
        e_tail, conv = self._tail(rem).batch_decode(
            win.reshape(B, rem * m), seed=seed + step)
        E ^= np.asarray(e_tail).astype(np.uint8)
        n_windows += 1
        conv_sum += float(np.asarray(conv).mean())
        return E.astype(np.int8), {
            "windows": n_windows,
            "converged": conv_sum / n_windows,
            "rounds": R,
        }
