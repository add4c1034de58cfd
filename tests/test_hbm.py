"""Device-memory budget model (utils/hbm.py, VERDICT r4 item 7).

The round-4 OOM guards were hardcoded folklore from one accelerator;
these tests pin the replacement: caps derive from a (fake) device budget,
so a smaller or larger device picks correct values without code edits.
"""

import numpy as np
import pytest

from ldpcdecoders_tpu.codes.graph import TannerGraph
from ldpcdecoders_tpu.utils.hbm import (
    device_hbm_bytes,
    max_lanes_for,
    minsum_bytes_per_lane,
)


def _graph(m=40, n=300, seed=0):
    rng = np.random.default_rng(seed)
    H = (rng.random((m, n)) < 0.08).astype(np.uint8)
    H[:, H.sum(axis=0) == 0] = 1
    return H, TannerGraph.from_pcm(H)


def test_explicit_bytes_win_over_detection():
    assert device_hbm_bytes(hbm_bytes=12_345) == 12_345


def test_env_override(monkeypatch):
    monkeypatch.setenv("LDPC_DEVICE_MEMORY_GB", "2.5")
    assert device_hbm_bytes() == int(2.5e9)


def test_per_lane_model_calibration():
    """The model reproduces the round-4 measured point: bb144 R=12
    (n=67072 mech, max_dv=12; m=1728 det, max_dc=294) at B=4096 f32
    compiled to 23.8 GB (artifact d94f696) — the model must land within
    15% so derived caps stay honest."""

    class G:  # shape-only stand-in for the R=12 DEM graph
        n, m, max_dv, max_dc = 67072, 1728, 12, 294

    modeled = 4096 * minsum_bytes_per_lane(G, 4)
    assert abs(modeled - 23.8e9) / 23.8e9 < 0.15


def test_small_chip_picks_small_caps():
    _, g = _graph()
    small = max_lanes_for(g, hbm_bytes=int(50e6), fraction=0.8)
    big = max_lanes_for(g, hbm_bytes=int(50e9), fraction=0.8)
    assert small < big
    assert big <= 16384  # hi clamp
    # power-of-two and floor-respecting
    assert small & (small - 1) == 0
    assert small >= 32


def test_budget_scales_linearly_until_clamp():
    _, g = _graph()
    one = max_lanes_for(g, hbm_bytes=int(1e9), fraction=1.0, hi=1 << 30)
    two = max_lanes_for(g, hbm_bytes=int(2e9), fraction=1.0, hi=1 << 30)
    assert two == 2 * one


def test_staged_caps_follow_fake_device():
    """StagedDemDecoder on a hypothetical 1 GB chip vs a 64 GB chip:
    both stage-0 and deep-bucket ceilings move, no code edits."""
    pytest.importorskip("scipy")
    from ldpcdecoders_tpu.native import native_available

    if not native_available():
        pytest.skip("native host OSD unavailable")
    from ldpcdecoders_tpu.models.staged import StagedDemDecoder

    rng = np.random.default_rng(0)
    A = (rng.random((40, 300)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(300) * 0.01, 1e-4, 0.01)
    small = StagedDemDecoder(A, pr, gammas=(0.3, 0.4),
                             hbm_bytes=int(1e9))
    large = StagedDemDecoder(A, pr, gammas=(0.3, 0.4),
                             hbm_bytes=int(64e9))
    assert small._max_stage0_batch <= large._max_stage0_batch
    assert small.max_bucket <= large.max_bucket
    # explicit override still wins
    forced = StagedDemDecoder(A, pr, gammas=(0.3, 0.4), max_bucket=64,
                              hbm_bytes=int(64e9))
    assert forced.max_bucket == 64


def test_tiny_budget_keeps_floor():
    _, g = _graph()
    assert max_lanes_for(g, hbm_bytes=1000, lo=32) == 32


class _FakeDevice:
    def __init__(self, stats, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
        self.platform, self.device_kind, self._stats = platform, kind, stats

    def memory_stats(self):
        return self._stats


def test_gpu_budget_is_bytes_limit(monkeypatch):
    """On a GPU the budget is the runtime's bytes_limit (JAX preallocates
    75% of an H100's 80 GB), and the staged caps follow from it: the
    bb144 R=6 DEM's stage-0 batch reaches its 8192 ceiling and the
    six-member bf16 deep bucket 2048 lanes."""
    monkeypatch.delenv("LDPC_DEVICE_MEMORY_GB", raising=False)
    dev = _FakeDevice({"bytes_limit": int(0.75 * 80e9), "bytes_in_use": 0})
    assert device_hbm_bytes(dev) == int(0.75 * 80e9)

    class G:  # shape-only stand-in for the bb144 R=6 DEM graph
        n, m, max_dv, max_dc = 31648, 864, 12, 294

    assert max_lanes_for(G, device=dev, fraction=0.85, lo=256, hi=8192) == 8192
    deep = max_lanes_for(G, dtype_bytes=2, device=dev, fraction=0.45,
                         lo=32, hi=16384)
    assert deep == 16384 and deep // 6 >= 2048


def test_gpu_without_bytes_limit_raises(monkeypatch):
    monkeypatch.delenv("LDPC_DEVICE_MEMORY_GB", raising=False)
    for stats in ({}, None, {"bytes_limit": 0}):
        with pytest.raises(RuntimeError, match="no memory limit"):
            device_hbm_bytes(_FakeDevice(stats))
    # the CPU keeps its host-RAM share and needs no stats
    assert device_hbm_bytes(_FakeDevice(None, platform="cpu", kind="cpu")) > 0
