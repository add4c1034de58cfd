"""Headline benchmark: BP decoding throughput on the reference's own
benchmark configuration (benchmark/benchmarks.jl: H = (1000, 10, 9)
Gallager code, per = 0.01, max_iters = 100).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no absolute numbers (BASELINE.md), so
``vs_baseline`` is measured against the build target from BASELINE.json:
>= 1e7 BP edge-iterations/s per device.  The primary value is measured with
early exit disabled (every lane runs all iterations), so it counts real
sustained message-update work, not convergence luck.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    import jax.numpy as jnp

    import ldpcdecoders_tpu as lt

    # persistent compilation cache (JAX_COMPILATION_CACHE_DIR where set,
    # else the checkout's .jax_cache; LDPC_JAX_CACHE=off opts out)
    lt.enable_compilation_cache()
    from ldpcdecoders_tpu.models.bp import make_bp_decode_fn
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn
    from ldpcdecoders_tpu.models.minsum_q import make_minsum_q_decode_fn

    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    graph = lt.TannerGraph.from_pcm(H)
    per, max_iters = 0.01, 100
    B = 1024

    rng = np.random.default_rng(0)
    # random (unsatisfiable-in-few-iters) syndromes: decoding a per=0.5
    # error pattern forces the full max_iters of message passing in nearly
    # every lane -> measures sustained kernel throughput
    hard_errs = rng.random((B, graph.n)) < 0.5
    hard_syns = jnp.asarray((hard_errs @ H.T) % 2, dtype=jnp.uint8)
    # realistic syndromes for the end-to-end decoded-syndromes/s number
    real_errs = rng.random((B, graph.n)) < per
    real_syns = jnp.asarray((real_errs @ H.T) % 2, dtype=jnp.uint8)

    def measure(fn, syns, reps=3):
        out = fn(syns)
        jax.block_until_ready(out)  # compile + warmup
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(syns)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        iters = int(np.max(np.asarray(out[2]))) or max_iters
        conv = float(np.asarray(out[1]).mean())
        return dt, iters, conv

    # flagship reference-parity sum-product BP (f32, slot-major): headline
    bp_fn = jax.jit(make_bp_decode_fn(graph, per, max_iters))
    dt_bp, it_bp, _ = measure(bp_fn, hard_syns)
    bp_edge_iters_per_s = B * it_bp * graph.n_edges / dt_bp
    dt_bpr, _, conv_bpr = measure(bp_fn, real_syns)

    # pipelined serving throughput: K batches in flight before the first
    # host sync — measures device-resident decode rate without paying the
    # per-call dispatch/transfer latency (the production serving pattern)
    K = 8
    out = bp_fn(real_syns)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [bp_fn(real_syns) for _ in range(K)]
    jax.block_until_ready(outs[-1])
    pipelined_syn_per_s = K * B / (time.perf_counter() - t0)

    # int8 min-sum production variant
    q_fn = jax.jit(make_minsum_q_decode_fn(graph, per, max_iters))
    dt_q, it_q, _ = measure(q_fn, hard_syns)
    q_edge_iters_per_s = B * it_q * graph.n_edges / dt_q
    dt_qr, _, conv_qr = measure(q_fn, real_syns)

    # bf16 min-sum
    bf_fn = jax.jit(make_minsum_decode_fn(graph, per, max_iters, dtype=jnp.bfloat16))
    dt_bf, it_bf, _ = measure(bf_fn, hard_syns)
    bf_edge_iters_per_s = B * it_bf * graph.n_edges / dt_bf

    # bf16 sum-product: same algorithm as the flagship at half the HBM
    # traffic — fastest measured variant (passes the reference's LER
    # oracles; f32 stays the headline for bit-level golden parity)
    bpbf_fn = jax.jit(
        make_bp_decode_fn(graph, per, max_iters, dtype=jnp.bfloat16)
    )
    dt_bpbf, it_bpbf, _ = measure(bpbf_fn, hard_syns)
    bpbf_edge_iters_per_s = B * it_bpbf * graph.n_edges / dt_bpbf

    # fused BP+OSD (guaranteed syndrome-consistent output) pipelined via
    # the public serving API — one XLA program, no host sync per batch
    bposd = lt.BeliefPropagationOSDDecoder(H, per, max_iters, fused=True)
    out = bposd.batch_decode_async(real_syns)  # device arrays stay resident
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    outs = [bposd.batch_decode_async(real_syns) for _ in range(K)]
    jax.block_until_ready(outs[-1][0])
    bposd_pipelined = K * B / (time.perf_counter() - t0)

    # end-to-end FER sweep throughput: the fully device-resident
    # evaluation pipeline (sample -> syndrome -> decode -> count on
    # device, one [4] fetch per batch) through the public harness
    from ldpcdecoders_tpu.harness import FERSweep

    SB = 16384
    sweep = FERSweep(
        H, lambda p: lt.MinSumDecoder(H, p, 60), [0.02], batch=SB,
        seed=3, multihost=False, sample_on_device=True, pipeline=4,
    )
    sweep.run(trials_per_point=SB)  # warm the compiled step
    t0 = time.perf_counter()
    out = sweep.run(trials_per_point=9 * SB)
    dt = time.perf_counter() - t0
    sweep_extra = {
        "fer_sweep_syndromes_per_s_device_resident": round(8 * SB / dt, 1),
        "fer_sweep_converged_fraction": out[0.02]["converged_fraction"],
    }

    # circuit-level tier: exact-DEM decode of the rotated surface code
    # (recommended damped-min-sum config), fully device-resident
    from ldpcdecoders_tpu.codes.circuit import circuit_dem, css_memory_circuit
    from ldpcdecoders_tpu.harness import dem_logical_sweep
    from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder

    c = css_memory_circuit(lt.surface_code_x(3), lt.surface_code_z(3),
                           3, p=0.003)
    A, pr, O = circuit_dem(c)
    cdec = DetectorGraphDecoder(A, pr, 100, observables=O, fused=True,
                                inner="minsum", damping=0.4)
    dem_logical_sweep(cdec, shots=2048, batch=2048, seed=5)  # warm
    cout = dem_logical_sweep(cdec, shots=16384, batch=2048, seed=5,
                             rounds=3)
    circuit_extra = {
        "circuit_level_shots_per_s": round(cout["throughput_shots_per_s"], 1),
        "circuit_level_ler_per_round": round(cout["per_round_rate"], 6),
    }

    target = 1e7  # BASELINE.json target: edge-iterations/s/device
    result = {
        "metric": "bp_edge_iterations_per_s_per_chip",
        "value": round(bp_edge_iters_per_s, 1),
        "unit": "edge_iters/s",
        "vs_baseline": round(bp_edge_iters_per_s / target, 3),
        "extra": {
            "flagship_decoder": "sumproduct_f32_slot_major",
            "minsum_int8_edge_iters_per_s": round(q_edge_iters_per_s, 1),
            "minsum_bf16_edge_iters_per_s": round(bf_edge_iters_per_s, 1),
            "sumproduct_bf16_edge_iters_per_s": round(bpbf_edge_iters_per_s, 1),
            "decoded_syndromes_per_s_sumproduct": round(B / dt_bpr, 1),
            "decoded_syndromes_per_s_sumproduct_pipelined": round(pipelined_syn_per_s, 1),
            "decoded_syndromes_per_s_minsum_int8": round(B / dt_qr, 1),
            "decoded_syndromes_per_s_bposd_fused_pipelined": round(bposd_pipelined, 1),
            **sweep_extra,
            **circuit_extra,
            "converged_fraction_real": conv_bpr,
            "batch": B,
            "iters_executed": it_bp,
            "edges": graph.n_edges,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main()
