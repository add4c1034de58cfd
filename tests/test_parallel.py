"""SPMD layer tests on an 8-virtual-device CPU mesh (conftest sets
--xla_force_host_platform_device_count=8)."""

import numpy as np
import pytest

import jax

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.parallel import (
    make_mesh,
    sharded_batch_decode,
    decode_with_stats,
    make_check_sharded_minsum_fn,
)


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 8, 4, rng=23)


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_data_parallel_bp_matches_single_device(code):
    H = code
    rng = np.random.default_rng(1)
    B = 32
    errs = rng.random((B, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.02, 50)
    ref_err, ref_conv = dec.batch_decode(syns)

    mesh = make_mesh(8)
    sh_err, sh_conv = sharded_batch_decode(dec, syns, mesh)
    assert np.array_equal(ref_err, sh_err)
    assert np.array_equal(ref_conv, sh_conv)


def test_data_parallel_rejects_indivisible_batch(code):
    dec = lt.BeliefPropagationDecoder(code, 0.02, 10)
    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        sharded_batch_decode(dec, np.zeros((7, code.shape[0])), mesh)


def test_decode_with_stats_allreduce(code):
    H = code
    rng = np.random.default_rng(2)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 50)
    mesh = make_mesh(8)
    err, conv, stats = decode_with_stats(dec, syns, mesh)
    assert stats["batch_size"] == B
    assert stats["converged_fraction"] == conv.mean()
    assert stats["max_iters_used"] >= 1


def test_check_sharded_minsum_matches_unsharded(code):
    """Tensor-parallel (check-sharded) min-sum must agree with the
    single-device min-sum decoder on errors and convergence."""
    H = code
    rng = np.random.default_rng(3)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2

    ref = lt.MinSumDecoder(H, 0.02, 50)
    ref_err, ref_conv = ref.batch_decode(syns)

    graph = ref.graph
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    fn = make_check_sharded_minsum_fn(graph, 0.02, 50, mesh)
    err, conv, iters = fn(syns)
    err, conv = np.asarray(err), np.asarray(conv)
    assert np.array_equal(ref_conv, conv)
    # min-sum is deterministic; messages differ only by psum association
    # order, so hard decisions must agree on converged lanes
    for b in np.flatnonzero(conv):
        assert np.array_equal(ref_err[b], err[b]), f"lane {b}"


def test_check_sharded_minsum_padding():
    """m not divisible by the model axis -> padded checks must be inert."""
    H = lt.toric_code_x(3)  # m=9, model axis 2 -> padded to 10
    rng = np.random.default_rng(4)
    B = 8
    errs = rng.random((B, H.shape[1])) < 0.03
    syns = (errs @ H.T) % 2
    graph = lt.TannerGraph.from_pcm(H)
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    fn = make_check_sharded_minsum_fn(graph, 0.03, 50, mesh)
    err, conv, _ = fn(syns)
    synhat = (np.asarray(err).astype(int) @ H.T) % 2
    for b in np.flatnonzero(np.asarray(conv)):
        assert np.array_equal(synhat[b], syns[b])


def test_check_sharded_dense_free_sparse_hgp():
    """The tensor-parallel path's whole purpose: codes too large to
    densify.  Build a ~112k-qubit hypergraph-product code as COO edge
    lists (no dense H anywhere), shard its checks over the model axis,
    and verify converged lanes reproduce their syndromes."""
    import scipy.sparse as sp

    from ldpcdecoders_tpu.codes import hypergraph_product_edges
    from ldpcdecoders_tpu.parallel import make_check_sharded_sumproduct_fn

    H1 = lt.parity_check_matrix(300, 6, 3, rng=7)  # [150, 300]
    hx, _ = hypergraph_product_edges(H1, H1)
    rows, cols, m, n = hx
    assert n == 300 * 300 + 150 * 150  # 112,500 qubits
    graph = lt.TannerGraph.from_edges(rows, cols, m, n)
    assert graph.H is None  # genuinely dense-free

    Hx = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(m, n)).tocsr()
    rng = np.random.default_rng(11)
    B = 8
    errs = np.zeros((B, n), np.int8)
    for b in range(B):  # weight-4 sparse errors: well within BP's reach
        errs[b, rng.choice(n, size=4, replace=False)] = 1
    syns = np.asarray((Hx @ errs.T).T % 2, np.int8)

    mesh = make_mesh(8, axis_names=("data", "model"), shape=(2, 4))
    for maker in (make_check_sharded_minsum_fn, make_check_sharded_sumproduct_fn):
        fn = maker(graph, 0.001, 30, mesh)
        err, conv, iters = fn(syns)
        err, conv = np.asarray(err), np.asarray(conv)
        assert conv.mean() > 0.9, maker.__name__
        synhat = np.asarray((Hx @ err.astype(np.int8).T).T % 2)
        for b in np.flatnonzero(conv):
            assert np.array_equal(synhat[b], syns[b]), (maker.__name__, b)


def test_check_sharded_sumproduct(code):
    """Tensor-parallel tanh-rule sum-product: converged lanes must be
    syndrome-consistent and agree with the single-device BP-OTS-style
    LLR decoding behavior (syndrome-level, not bitwise)."""
    from ldpcdecoders_tpu.parallel import make_check_sharded_sumproduct_fn

    H = code
    rng = np.random.default_rng(5)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    graph = lt.TannerGraph.from_pcm(H)
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    fn = make_check_sharded_sumproduct_fn(graph, 0.02, 50, mesh)
    err, conv, iters = fn(syns)
    err, conv = np.asarray(err), np.asarray(conv)
    assert conv.mean() > 0.9
    synhat = (err.astype(int) @ H.T) % 2
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], syns[b])
    # syndrome-level is the contract (float reduction order varies across
    # meshes/versions); exact recovery is the overwhelmingly likely outcome
    # at this noise, so require it for most lanes without demanding all
    assert (err[conv].astype(bool) == errs[conv]).all(axis=1).mean() > 0.8


def test_sharded_mixed_decode():
    """Mixed-channel decode sharded over the batch axis: results match
    the unsharded decoder exactly."""
    from ldpcdecoders_tpu.parallel import sharded_mixed_decode

    mesh8 = make_mesh(8)
    H = lt.parity_check_matrix(120, 6, 3, rng=0)
    dec = lt.MixedChannelDecoder(H, 0.01, 30, osd_order=0)
    rng = np.random.default_rng(3)
    B, n = 32, 120
    eps = rng.random((B, n)) < 0.08
    e = np.where(eps, rng.random((B, n)) < 0.5, rng.random((B, n)) < 0.01)
    syn = ((e @ H.T) % 2).astype(np.int8)
    err_s, ok_s = sharded_mixed_decode(dec, syn, eps, mesh8)
    err_u, ok_u = dec.batch_decode(syn, eps)
    assert np.array_equal(err_s, err_u)
    assert np.array_equal(ok_s, ok_u)
    with pytest.raises(ValueError, match="erasures of shape"):
        sharded_mixed_decode(dec, syn, eps[:, :5], mesh8)
