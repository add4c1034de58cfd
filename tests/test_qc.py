"""Quasi-cyclic LDPC family: lifting, I/O, and the QC decoder.

The QC decoder runs the generic edge-list decoders on the lifted graph;
tests here pin it to the golden NumPy decoders (golden/numpy_ref.py) on
small codes: hard decisions, convergence flags and iteration counts.
"""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.golden.numpy_ref import bp_decode, minsum_decode
from ldpcdecoders_tpu.codes.qc import (
    load_base_matrix,
    qc_lift,
    qc_lift_edges,
    random_qc_base_matrix,
    save_base_matrix,
)


def test_qc_lift_circulant_structure():
    # one block, shift 2, Z=5: P^2[r, c] = 1 iff c == (r+2) % 5
    H = qc_lift([[2]], 5)
    expect = np.zeros((5, 5), np.uint8)
    for r in range(5):
        expect[r, (r + 2) % 5] = 1
    assert np.array_equal(H, expect)
    # -1 is an all-zero block; shift 0 is the identity
    H2 = qc_lift([[0, -1]], 3)
    assert np.array_equal(H2[:, :3], np.eye(3, dtype=np.uint8))
    assert H2[:, 3:].sum() == 0


def test_qc_lift_edges_matches_dense():
    base = random_qc_base_matrix(8, 4, 2, 16, rng=3)
    rows, cols, m, n = qc_lift_edges(base, 16)
    H = np.zeros((m, n), np.uint8)
    H[rows, cols] = 1
    assert np.array_equal(H, qc_lift(base, 16))


def test_random_qc_base_regularity():
    base = random_qc_base_matrix(12, 4, 2, 32, rng=0)
    support = base >= 0
    assert (support.sum(axis=1) == 4).all()
    assert (support.sum(axis=0) == 2).all()
    assert base[support].min() >= 0 and base[support].max() < 32
    # the lifted code is (wr, wc)-regular
    H = qc_lift(base, 32)
    assert set(H.sum(axis=1)) == {4} and set(H.sum(axis=0)) == {2}


def test_base_matrix_io_roundtrip(tmp_path):
    base = random_qc_base_matrix(8, 4, 2, 64, rng=1)
    path = tmp_path / "base.txt"
    save_base_matrix(base, 64, path)
    loaded, Z = load_base_matrix(path)
    assert Z == 64
    assert np.array_equal(loaded, base)


def test_base_matrix_validation():
    with pytest.raises(ValueError, match="shifts in"):
        qc_lift([[5]], 4)  # shift >= Z
    with pytest.raises(ValueError, match="shifts in"):
        qc_lift([[-2]], 4)
    with pytest.raises(ValueError, match="2-D"):
        qc_lift([1, 2], 4)


@pytest.fixture(scope="module")
def small_qc():
    base = random_qc_base_matrix(6, 3, 2, 16, rng=5)  # mb=4, Eb=12
    return base, 16, qc_lift(base, 16)


def test_qc_xla_backend_recovers_errors(small_qc):
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.02, 30)
    rng = np.random.default_rng(11)
    errs = (rng.random((64, dec.n)) < 0.01).astype(np.int8)
    syn = (errs @ H.T) % 2
    out, conv = dec.batch_decode(syn)
    s2 = (out.astype(np.int64) @ H.T) % 2
    assert conv.mean() > 0.9
    assert (s2[conv] == syn[conv]).all()
    assert out.dtype == np.int8


def test_qc_decoder_validation(small_qc):
    base, Z, _ = small_qc
    with pytest.raises(TypeError, match="backend"):
        lt.QCMinSumDecoder(base, Z, 0.05, 5, backend="xla")  # one path only
    dec = lt.QCMinSumDecoder(base, Z, 0.05, 5)
    assert dec.supports_per_override and dec.supports_vector_prior
    with pytest.raises(ValueError, match="per must be"):
        dec.batch_decode(np.zeros((4, dec.m), np.int8),
                         per=np.full(dec.n + 1, 0.1))


def test_config_builds_qc_decoder(small_qc):
    from ldpcdecoders_tpu.config import DecoderConfig

    base, Z, H = small_qc
    cfg = DecoderConfig(kind="qc_minsum", per=0.02, max_iters=15)
    assert DecoderConfig.from_json(cfg.to_json()) == cfg
    dec = cfg.build((base, Z))
    assert isinstance(dec, lt.QCMinSumDecoder)
    assert not hasattr(dec, "backend")
    rng = np.random.default_rng(9)
    err = (rng.random(dec.n) < 0.01).astype(np.int8)
    out, conv = dec.decode((H @ err) % 2)
    assert conv and np.array_equal(out, err)
    with pytest.raises(ValueError, match=r"\(base, Z\) tuple"):
        cfg.build(H)  # a lifted flat matrix loses the circulant structure


def test_cli_bench_qc(capsys):
    from ldpcdecoders_tpu.cli import main

    rc = main(
        [
            "bench",
            "--code", "qc:6,3,2,16",
            "--decoder", "qc_minsum",
            "--batch", "32",
            "--max-iters", "20",
            "--reps", "2",
        ]
    )
    assert rc == 0
    import json

    out = json.loads(capsys.readouterr().out)
    assert out["decoder"] == "qc_minsum" and out["syndromes_per_s"] > 0


def test_cli_qc_decoder_requires_qc_code():
    from ldpcdecoders_tpu.cli import main

    with pytest.raises(SystemExit, match="quasi-cyclic"):
        main(["bench", "--code", "gallager:120,6,3", "--decoder", "qc_minsum"])


def test_cli_qcbase_file_spec(tmp_path, capsys):
    from ldpcdecoders_tpu.cli import main

    base = random_qc_base_matrix(6, 3, 2, 16, rng=5)
    path = tmp_path / "base.txt"
    save_base_matrix(base, 16, path)
    rc = main(
        [
            "bench",
            "--code", f"qcbase:{path}",
            "--decoder", "qc_minsum",
            "--batch", "16",
            "--max-iters", "10",
            "--reps", "1",
        ]
    )
    assert rc == 0


# ---- 2-D group-circulant (bivariate bicycle) support -----------------------


def test_qc_group_lift_matches_bicycle_dense():
    from ldpcdecoders_tpu.codes.bicycle import named_bicycle_code
    from ldpcdecoders_tpu.codes.qc import qc_group_lift_edges

    Hx, Hz, info = named_bicycle_code("bb72")
    l, m = info["l"], info["m"]
    terms = [(0, 0, a, b) for a, b in info["a_terms"]] + [
        (0, 1, a, b) for a, b in info["b_terms"]
    ]
    rows, cols, mc, n = qc_group_lift_edges(terms, 1, 2, l, m)
    H = np.zeros((mc, n), np.uint8)
    H[rows, cols] = 1
    assert np.array_equal(H, Hx)


def test_qc_group_lift_validation():
    from ldpcdecoders_tpu.codes.qc import qc_group_lift_edges

    with pytest.raises(ValueError, match="duplicate term"):
        qc_group_lift_edges([(0, 0, 1, 1), (0, 0, 1, 1)], 1, 1, 2, 2)
    with pytest.raises(ValueError, match="outside"):
        qc_group_lift_edges([(0, 1, 0, 0)], 1, 1, 2, 2)
    with pytest.raises(ValueError, match="outside"):
        qc_group_lift_edges([(0, 0, 2, 0)], 1, 1, 2, 2)


def test_for_bicycle_blocks_match_dense():
    from ldpcdecoders_tpu.codes.bicycle import named_bicycle_code

    Hx, Hz, _ = named_bicycle_code("bb72")
    dx = lt.QCMinSumDecoder.for_bicycle("bb72", "x", 0.01, 10)
    dz = lt.QCMinSumDecoder.for_bicycle("bb72", "z", 0.01, 10)
    assert np.array_equal(np.asarray(dx.graph.H), Hx)
    assert np.array_equal(np.asarray(dz.graph.H), Hz)
    with pytest.raises(ValueError, match="block"):
        lt.QCMinSumDecoder.for_bicycle("bb72", "y", 0.01, 10)
    with pytest.raises(ValueError, match="unknown BB code"):
        lt.QCMinSumDecoder.for_bicycle("bb9000", "x", 0.01, 10)


def test_from_group_terms_recovers_errors():
    # decode both blocks of the gross code at low noise
    from ldpcdecoders_tpu.codes.bicycle import named_bicycle_code

    Hx, Hz, _ = named_bicycle_code("bb144")
    for block, H in (("x", Hx), ("z", Hz)):
        dec = lt.QCMinSumDecoder.for_bicycle("bb144", block, 0.005, 40)
        rng = np.random.default_rng(3)
        errs = (rng.random((32, dec.n)) < 0.005).astype(np.int8)
        syn = (errs @ H.T) % 2
        out, conv = dec.batch_decode(syn)
        s2 = (out.astype(np.int64) @ H.T) % 2
        assert conv.mean() > 0.9
        assert (s2[conv] == syn[conv]).all()


# ---- layered schedule -------------------------------------------------------


def test_qc_layered_converges_in_fewer_sweeps(small_qc):
    base, Z, H = small_qc
    per = 0.05
    flood = lt.QCMinSumDecoder(base, Z, per, 30, schedule="flooding")
    layer = lt.QCMinSumDecoder(base, Z, per, 30, schedule="layered")
    rng = np.random.default_rng(1)
    errs = (rng.random((16, flood.n)) < 0.04).astype(np.int8)
    syn = (errs @ H.T) % 2
    _, cf, itf, _, _ = flood.batch_decode_detailed(syn)
    el, cl, itl, _, _ = layer.batch_decode_detailed(syn)
    assert cl.mean() >= cf.mean()
    conv_both = np.asarray(cf) & np.asarray(cl)
    assert conv_both.any()
    assert np.asarray(itl)[conv_both].mean() < np.asarray(itf)[conv_both].mean()
    # converged layered lanes reproduce their syndromes
    s2 = (np.asarray(el).astype(np.int64) @ H.T) % 2
    assert (s2[np.asarray(cl)] == syn[np.asarray(cl)]).all()


def test_qc_layered_xla_backend_and_validation(small_qc):
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.03, 30, schedule="layered")
    rng = np.random.default_rng(2)
    errs = (rng.random((16, dec.n)) < 0.02).astype(np.int8)
    syn = (errs @ H.T) % 2
    out, conv = dec.batch_decode(syn)
    s2 = (out.astype(np.int64) @ H.T) % 2
    assert conv.mean() > 0.9
    assert (s2[conv] == syn[conv]).all()
    with pytest.raises(ValueError, match="schedule"):
        lt.QCMinSumDecoder(base, Z, 0.03, 5, schedule="bogus")
    with pytest.raises(ValueError, match="layered sum-product"):
        lt.QCMinSumDecoder(base, Z, 0.03, 15, algorithm="sumproduct",
                           schedule="layered")
    with pytest.raises(ValueError, match="algorithm"):
        lt.QCMinSumDecoder(base, Z, 0.03, 15, algorithm="bogus")


def test_config_qc_layered(small_qc):
    from ldpcdecoders_tpu.config import DecoderConfig

    base, Z, H = small_qc
    cfg = DecoderConfig(kind="qc_minsum", per=0.03, max_iters=20, schedule="layered")
    assert DecoderConfig.from_json(cfg.to_json()) == cfg
    dec = cfg.build((base, Z))
    assert dec.schedule == "layered" and dec.alpha == 0.8
    rng = np.random.default_rng(4)
    err = (rng.random(dec.n) < 0.02).astype(np.int8)
    out, conv = dec.decode((H @ err) % 2)
    if conv:
        assert np.array_equal((H @ out.astype(np.int64)) % 2, (H @ err) % 2)


def test_qc_bf16_backends(small_qc):
    import jax.numpy as jnp

    base, Z, H = small_qc
    rng = np.random.default_rng(8)
    errs = (rng.random((16, H.shape[1])) < 0.02).astype(np.int8)
    syn = (errs @ H.T) % 2
    for schedule in ("layered", "flooding"):
        dec = lt.QCMinSumDecoder(
            base, Z, 0.03, 20, schedule=schedule, dtype=jnp.bfloat16,
        )
        out, conv = dec.batch_decode(syn)
        s2 = (out.astype(np.int64) @ H.T) % 2
        assert conv.mean() > 0.9, schedule
        assert (s2[conv] == syn[conv]).all(), schedule
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lt.QCMinSumDecoder(base, Z, 0.03, 5, dtype=jnp.int8)


# ---- sum-product algorithm --------------------------------------------------


def test_config_qc_algorithm(small_qc):
    from ldpcdecoders_tpu.config import DecoderConfig

    base, Z, H = small_qc
    cfg = DecoderConfig(kind="qc_minsum", per=0.02, max_iters=20,
                        algorithm="sumproduct")
    assert DecoderConfig.from_json(cfg.to_json()) == cfg
    dec = cfg.build((base, Z))
    assert dec.algorithm == "sumproduct"
    rng = np.random.default_rng(14)
    err = (rng.random(dec.n) < 0.01).astype(np.int8)
    out, conv = dec.decode((H @ err) % 2)
    assert conv and np.array_equal(out, err)


def test_qc_weight_one_row_finite_llrs():
    """A weight-1 base row must emit finite messages (review finding:
    an inf min2 sentinel propagated NaN through the variable totals)."""
    base = np.array([[0], [1]])
    dx = lt.QCMinSumDecoder(base, 4, 0.05, 5)
    syn = np.zeros((4, dx.m), np.int8)
    syn[0, 0] = 1
    ex, cx, ix, auxx, _ = dx.batch_decode_detailed(syn)
    assert np.isfinite(np.asarray(auxx["llrs"])).all()
    H = qc_lift(base, 4)
    for b in range(4):
        g_err, g_conv, _, g_it = minsum_decode(H, syn[b], 0.05, 5)
        assert np.array_equal(ex[b], g_err) and cx[b] == g_conv and ix[b] == g_it


def test_qc_sumproduct_xla_vector_prior(small_qc):
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.02, 20, algorithm="sumproduct")
    rng = np.random.default_rng(15)
    errs = (rng.random((8, dec.n)) < 0.01).astype(np.int8)
    syn = (errs @ H.T) % 2
    out, conv = dec.batch_decode(syn, per=np.full(dec.n, 0.02))
    assert conv.mean() > 0.9
    s2 = (out.astype(np.int64) @ H.T) % 2
    assert (s2[conv] == syn[conv]).all()


# ---- the QC decoder against the golden NumPy decoders ------------------------


def _assert_matches_golden(dec, H, syn, golden, **kw):
    """Every lane: hard decisions, convergence flag and iteration count
    equal to the golden decoder's; LLRs to float32 rounding."""
    err, conv, iters, aux, _ = dec.batch_decode_detailed(syn, **kw)
    soft = aux.get("llrs", aux.get("log_probabs"))
    per = kw.get("per", dec.per)
    for b in range(syn.shape[0]):
        p = per[b] if np.ndim(per) == 2 else per
        g_err, g_conv, g_soft, g_it = golden(H, syn[b], p, dec.max_iters)
        assert np.array_equal(err[b], np.asarray(g_err).astype(np.int8)), b
        assert conv[b] == g_conv and iters[b] == g_it, b
        np.testing.assert_allclose(np.asarray(soft[b]), g_soft, rtol=1e-4, atol=1e-3)
    return err, conv


def test_qc_minsum_matches_numpy_reference(small_qc):
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.05, 12)
    rng = np.random.default_rng(2)
    syn = ((rng.random((8, dec.n)) < 0.03).astype(np.int8) @ H.T) % 2
    _, conv = _assert_matches_golden(dec, H, syn, minsum_decode)
    assert conv.any()


def test_qc_sumproduct_matches_numpy_reference(small_qc):
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.02, 25, algorithm="sumproduct")
    rng = np.random.default_rng(12)
    errs = (rng.random((8, dec.n)) < 0.015).astype(np.int8)
    golden = lambda *a: bp_decode(*a, dtype=np.float32)  # noqa: E731
    err, conv = _assert_matches_golden(dec, H, (errs @ H.T) % 2, golden)
    assert np.array_equal(err[conv], errs[conv])


def test_bicycle_qc_matches_numpy_reference():
    from ldpcdecoders_tpu.codes.bicycle import named_bicycle_code

    Hx, _, _ = named_bicycle_code("bb72")
    dec = lt.QCMinSumDecoder.for_bicycle("bb72", "x", 0.01, 20)
    rng = np.random.default_rng(7)
    syn = ((rng.random((8, dec.n)) < 0.02).astype(np.int8) @ Hx.T) % 2
    _, conv = _assert_matches_golden(dec, Hx, syn, minsum_decode)
    assert conv.any()


def test_qc_batch_padding_and_single_matches_reference(small_qc):
    """Single decodes and odd batch widths give the golden per-lane
    results, and decode() equals lane 0 of batch_decode()."""
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.05, 8)
    rng = np.random.default_rng(4)
    err = (rng.random(dec.n) < 0.02).astype(np.int8)
    syn = (H @ err) % 2
    out, conv = dec.decode(syn)
    assert out.shape == (dec.n,)
    g_err, g_conv, _, _ = minsum_decode(H, syn, 0.05, 8)
    assert np.array_equal(out, g_err) and conv == g_conv
    for B in (1, 5):
        outs, _ = _assert_matches_golden(dec, H, np.tile(syn, (B, 1)), minsum_decode)
        assert outs.shape == (B, dec.n)
        assert np.array_equal(outs[0], out)


def test_qc_per_override_matches_reference(small_qc):
    """Scalar, per-bit and per-lane prior overrides match the golden
    decoder run at the same priors."""
    base, Z, H = small_qc
    per = 0.05
    dec = lt.QCMinSumDecoder(base, Z, per, 25)
    rng = np.random.default_rng(2)
    n, B = dec.n, 6
    eps = rng.random((B, n)) < 0.08
    e = np.where(eps, rng.random((B, n)) < 0.5, rng.random((B, n)) < per)
    syn = ((e @ H.T) % 2).astype(np.int8)
    for p in (np.where(eps, 0.5, per), 0.03, np.full(n, 0.02)):
        _assert_matches_golden(dec, H, syn, minsum_decode, per=p)


def test_qc_decode_soft_punctured_matches_reference(small_qc):
    """decode_soft through the QC decoder: punctured bits (LLR 0) recover
    from parity structure alone (the 5G rate-matching pattern), with the
    golden decoder agreeing at the same per-bit priors."""
    base, Z, H = small_qc
    dec = lt.QCMinSumDecoder(base, Z, 0.02, 40)
    n = dec.n
    rng = np.random.default_rng(3)
    B = 8
    sigma = 10 ** (-4.0 / 20)
    llr = 2.0 * (1.0 + sigma * rng.standard_normal((B, n))) / sigma**2
    llr[:, :Z] = 0.0  # puncture one block column
    cw, ok = lt.decode_soft(dec, llr)
    assert ok.all()
    assert cw.sum() == 0  # all-zero codeword, punctured bits included
    hard = (llr < 0).astype(np.int8)
    p_wrong = np.clip(1.0 / (1.0 + np.exp(np.abs(llr))), 1e-12, 0.5)
    for b in range(B):
        g_err, g_conv, _, _ = minsum_decode(H, (H @ hard[b]) % 2, p_wrong[b], 40)
        assert g_conv and np.array_equal(hard[b] ^ g_err, cw[b])
