"""Low-latency serving: fused BP+OSD with device-resident pipelining.

The fused decoder compiles BP and cond-gated OSD post-processing into
ONE XLA program — no device->host synchronization per batch — so
several batches can be queued in flight and decode at full device
throughput, where the default path compacts failing lanes on the host
between batches.

Run:  python examples/async_serving.py
"""

import time

import numpy as np

import jax
import ldpcdecoders_tpu as lt

H = lt.parity_check_matrix(1000, 10, 9, rng=42)
per, max_iters, B = 0.01, 100, 1024

dec = lt.BeliefPropagationOSDDecoder(H, per, max_iters, fused=True)

rng = np.random.default_rng(0)
batches = []
for _ in range(8):
    errs = rng.random((B, H.shape[1])) < per
    batches.append(((errs @ H.T) % 2).astype(np.uint8))

# warm up (compiles once; the persistent cache makes re-runs fast)
dec.batch_decode(batches[0])

# queue every batch before reading any result: dispatch overlaps compute
t0 = time.perf_counter()
in_flight = [dec.batch_decode_async(b) for b in batches]
results = [(np.asarray(e), np.asarray(c)) for e, c in in_flight]
dt = time.perf_counter() - t0

total = len(batches) * B
conv = np.mean([c.mean() for _, c in results])
print(f"{total} syndromes in {dt*1e3:.0f} ms -> {total/dt:,.0f} syndromes/s "
      f"(converged fraction {conv:.3f}, always syndrome-consistent)")
