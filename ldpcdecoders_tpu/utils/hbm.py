"""Device-memory budgets for batch/bucket sizing (VERDICT r4 item 7).

Round 4 hardcoded two folklore constants after observing OOMs on one
accelerator (``_MAX_STAGE0_BATCH = 2048``, ``max_bucket = 256``); on any
other device those are silently wrong in one direction or the other.
This module derives them instead:

  * :func:`device_hbm_bytes` — the accelerator's usable memory: the
    runtime's ``device.memory_stats()['bytes_limit']`` (on a GPU, the
    share JAX preallocates: 75% of the card by default, or
    ``XLA_PYTHON_CLIENT_MEM_FRACTION``), half the host RAM on the CPU.
    An accelerator that reports no limit is an error, not a guess.
    ``LDPC_DEVICE_MEMORY_GB`` overrides the detection.
  * :func:`minsum_bytes_per_lane` — the measured peak-memory model of one
    ``make_minsum_decode_fn`` batch lane.  The live set is the
    variable-side messages ``[B, max_dv, n]`` (x2: nu plus the gathered
    Mg) and the check-side ``[B, max_dc, m]`` (x2: mu plus Ng), of
    which XLA keeps roughly one of each alive after fusion; the 1.25
    headroom factor calibrates the model to the measured 23.8 GB at
    B=4096 on the bb144 R=12 DEM (5.81 MB/lane measured vs 5.25
    modeled, round-4 artifact d94f696).
  * :func:`max_lanes_for` — the largest power-of-two lane count a
    budget fraction admits.

The reference has no analog (single-syndrome CPU loops never meet a
memory ceiling); this is what lets the staged production tier
(models/staged.py) pick correct caps on any device without code edits.
"""

from __future__ import annotations

import os

__all__ = [
    "device_hbm_bytes",
    "minsum_bytes_per_lane",
    "max_lanes_for",
]

#: calibration of the analytic per-lane model to measured XLA peaks
#: (bb144 R=12, B=4096: 23.8 GB measured vs 21.5 GB modeled at 1.25)
_HEADROOM = 1.25


def device_hbm_bytes(device=None, *, hbm_bytes: int | None = None) -> int:
    """Usable accelerator memory in bytes for ``device`` (default: the
    first device).  ``hbm_bytes`` forces the answer (unit tests /
    callers that already know); the ``LDPC_DEVICE_MEMORY_GB`` env var
    overrides all detection."""
    if hbm_bytes is not None:
        return int(hbm_bytes)
    env = os.environ.get("LDPC_DEVICE_MEMORY_GB")
    if env:
        return int(float(env) * 1e9)
    if device is None:
        import jax

        device = jax.devices()[0]
    if getattr(device, "platform", "") == "cpu":
        # half of host RAM: CPU "device memory" is shared with everything
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        return int(0.5 * pages * page)
    stats = device.memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError(
            f"{getattr(device, 'device_kind', device)} reports no memory "
            "limit; pass hbm_bytes= or set LDPC_DEVICE_MEMORY_GB")
    return int(stats["bytes_limit"])


def minsum_bytes_per_lane(graph, dtype_bytes: int = 4) -> float:
    """Peak-HBM estimate for ONE batch lane of a min-sum/sum-product
    decode program over ``graph`` (see module docstring for the
    calibration)."""
    return _HEADROOM * dtype_bytes * (
        graph.max_dv * graph.n + graph.max_dc * graph.m)


def max_lanes_for(graph, *, dtype_bytes: int = 4, fraction: float = 0.85,
                  device=None, hbm_bytes: int | None = None,
                  lo: int = 32, hi: int = 16384) -> int:
    """Largest power-of-two lane count whose modeled peak fits within
    ``fraction`` of the device budget, clamped to ``[lo, hi]``.

    ``fraction`` < 1 leaves room for the program's other residents —
    stage-0 buffers pipelined alongside a deep bucket, output arrays,
    the XLA workspace.  Returns at least ``lo`` even when the model
    says otherwise (a too-small cap deadlocks batching; a genuinely
    too-big ``lo`` will OOM loudly, which beats decoding nothing).
    """
    budget = device_hbm_bytes(device, hbm_bytes=hbm_bytes) * float(fraction)
    per = minsum_bytes_per_lane(graph, dtype_bytes)
    lanes = int(budget / per) if per > 0 else hi
    p = lo
    while p * 2 <= min(lanes, hi):
        p *= 2
    return p
