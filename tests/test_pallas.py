"""GF(2) elimination kernel tests (Pallas interpret mode on the CPU): the
kernel must match the XLA form of ops/gf2.py bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.ops.gf2 import gf2_eliminate, gf2_osd0, pack_bits
from ldpcdecoders_tpu.ops.pallas_gf2 import (
    fits_block,
    gf2_eliminate_pallas,
    gf2_osd0_pallas,
)


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 8, 4, rng=37)


def _packed(H):
    """``[B, m, n]`` 0/1 -> (Hp [B, m, W], Ht [B, W, m]) uint32."""
    Hp = jax.vmap(pack_bits)(jnp.asarray(H))
    return Hp, jnp.transpose(Hp, (0, 2, 1))


def _eliminate_both(H, s, n):
    _, Ht = _packed(H)
    ref = jax.vmap(lambda ht, sv: gf2_eliminate(ht, sv, n))(Ht, jnp.asarray(s))
    return ref[:3], gf2_eliminate_pallas(Ht, jnp.asarray(s), n, interpret=True)


def test_pallas_gf2_eliminate_matches_xla(code):
    """Gauss–Jordan kernel vs ops/gf2.py::gf2_eliminate: bitwise-identical
    eliminated matrix, syndrome, and pivot map."""
    rng = np.random.default_rng(4)
    for B, m, n, dens in ((4, 60, 80, 0.3), (2, 96, 240, 0.05), (3, 31, 33, 0.5)):
        H = (rng.random((B, m, n)) < dens).astype(np.uint32)
        s = (rng.random((B, m)) < 0.5).astype(np.uint32)
        ref, out = _eliminate_both(H, s, n)
        for name, a, b in zip(("Ht", "s", "piv"), ref, out):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (name, B, m, n)


def test_pallas_osd0_eliminate_matches_xla(code):
    """OSD-0 kernel vs ops/gf2.py::gf2_osd0: identical corrections
    (lane 0 takes a random residual; these random H have full row rank,
    so it is still in the column space)."""
    rng = np.random.default_rng(6)
    for B, m, n, dens in ((4, 60, 80, 0.3), (2, 31, 33, 0.5)):
        H = (rng.random((B, m, n)) < dens).astype(np.uint32)
        bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
        extra = (rng.random((B, n)) < 0.1).astype(np.uint32)
        resid = (np.einsum("bmn,bn->bm", H, extra) % 2).astype(np.uint32)
        resid[0] = rng.random(m) < 0.5  # possibly outside the row space
        Hp, Ht = _packed(H)
        ref = jax.vmap(lambda hp, b, r: gf2_osd0(hp, b, r, n))(
            Hp, jnp.asarray(bp), jnp.asarray(resid)
        )
        out = gf2_osd0_pallas(Ht, jnp.asarray(resid), jnp.asarray(bp), n, interpret=True)
        assert np.array_equal(np.asarray(ref), np.asarray(out)), (B, m, n)


def test_pallas_osd_decoder_matches_xla(code):
    """Full BP+OSD decodes (orders 0 and 2) through the kernels
    (interpreter) must equal the XLA elimination bit for bit."""
    from ldpcdecoders_tpu.models import bposd

    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    rng = np.random.default_rng(5)
    B = 8
    # high noise so several lanes fail BP and the OSD-0 path does real work
    errs = rng.random((B, H.shape[1])) < 0.06
    syns = (errs @ H.T) % 2

    orig_w, orig_0 = bposd.gf2_eliminate_pallas, bposd.gf2_osd0_pallas
    bposd.gf2_eliminate_pallas = lambda *a, **k: orig_w(*a, **k, interpret=True)
    bposd.gf2_osd0_pallas = lambda *a, **k: orig_0(*a, **k, interpret=True)
    try:
        for order in (0, 2):
            ref = lt.BeliefPropagationOSDDecoder(H, 0.06, 30, osd_order=order)
            e_ref, c_ref = ref.batch_decode(syns)
            osd0, osdw = bposd.make_osd_fns(ref.graph, order, kernel=True)
            bp_err, conv, iters, logp = ref._bp_fn(jnp.asarray(syns), None)
            if order == 0:
                need = np.flatnonzero(~np.asarray(conv))
                assert need.size > 0, "test needs BP-failing lanes"
                e_pl = np.asarray(bp_err).copy()
                sub = np.asarray(osd0(jnp.asarray(syns[need]), bp_err[need], logp[need]))
                e_pl[need] = sub.astype(np.int8)
            else:
                e_pl = np.asarray(osdw(jnp.asarray(syns), bp_err, logp))
            assert np.array_equal(e_ref, e_pl.astype(np.int8)), f"order {order}"
    finally:
        bposd.gf2_eliminate_pallas, bposd.gf2_osd0_pallas = orig_w, orig_0


def test_pallas_osd0_rank_deficient_code():
    """On a rank-deficient Gallager code (the reference code's shape of
    H), residuals of real syndromes give the XLA form's corrections."""
    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    m, n = H.shape
    rng = np.random.default_rng(8)
    B = 16
    perms = np.stack([rng.permutation(n) for _ in range(B)])
    Hb = H[:, perms].transpose(1, 0, 2).astype(np.uint32)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    x = (rng.random((B, n)) < 0.1).astype(np.uint32)
    resid = (np.einsum("bmn,bn->bm", Hb, x) % 2).astype(np.uint32)
    Hp, Ht = _packed(Hb)
    ref = jax.vmap(lambda hp, b, r: gf2_osd0(hp, b, r, n))(
        Hp, jnp.asarray(bp), jnp.asarray(resid))
    out = gf2_osd0_pallas(Ht, jnp.asarray(resid), jnp.asarray(bp), n, interpret=True)
    assert np.array_equal(np.asarray(ref), np.asarray(out))


@pytest.mark.parametrize(
    "m,n",
    [
        (17, 33),  # n one past a word, m far from a power of two
        (100, 95),  # m past n: the rank saturates before the columns end
        (48, 64),  # whole words, m not a power of two
    ],
)
def test_pallas_gf2_padding(m, n):
    """Shapes the kernel pads to its power-of-two block (n not a multiple
    of 32, m not a power of two) give the XLA form's results."""
    rng = np.random.default_rng(m * 1000 + n)
    B = 3
    H = (rng.random((B, m, n)) < 0.2).astype(np.uint32)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    ref, out = _eliminate_both(H, s, n)
    for name, a, b in zip(("Ht", "s", "piv"), ref, out):
        assert a.shape == b.shape, name
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    bp = (rng.random((B, n)) < 0.3).astype(np.uint32)
    Hp, Ht = _packed(H)
    ref0 = jax.vmap(lambda hp, b, r: gf2_osd0(hp, b, r, n))(
        Hp, jnp.asarray(bp), jnp.asarray(s))
    out0 = gf2_osd0_pallas(Ht, jnp.asarray(s), jnp.asarray(bp), n, interpret=True)
    assert np.array_equal(np.asarray(ref0), np.asarray(out0))


def test_pallas_gf2_choice_by_shape():
    """The kernel is chosen where one lane's packed matrix fits its block
    (128 KB after power-of-two padding): the (1000, 10, 9) reference code
    fits; the bb144 circuit-level DEM (864 x 31,648) does not; the decoder
    records the choice."""
    assert fits_block(1000, 900)
    assert fits_block(1024, 1024)
    assert fits_block(40_000, 8)  # 2048 words x 16 rows
    assert not fits_block(1025, 1024)
    assert not fits_block(31_648, 864)
    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    assert lt.BeliefPropagationOSDDecoder(H, 0.05, 10).osd_kernel
    wide = lt.parity_check_matrix(1100, 11, 9, rng=1)  # 35 words x 900 rows
    assert not lt.BeliefPropagationOSDDecoder(wide, 0.05, 10).osd_kernel


def test_pallas_gf2_lane_parallel_under_sharding():
    """A batch-sharded caller runs the kernel on each device's own lanes:
    same results, batch-sharded outputs, and no gather in the program."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    rng = np.random.default_rng(9)
    B, m, n = 8, 40, 70
    H = (rng.random((B, m, n)) < 0.3).astype(np.uint32)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    ref, _ = _eliminate_both(H, s, n)
    _, Ht = _packed(H)
    Ht = jax.device_put(Ht, NamedSharding(mesh, P("data", None, None)))
    sv = jax.device_put(jnp.asarray(s), NamedSharding(mesh, P("data", None)))
    f = jax.jit(lambda a, b: gf2_eliminate_pallas(a, b, n, interpret=True))
    out = f(Ht, sv)
    for a, b in zip(ref, out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert out[2].sharding.spec[0] == "data"
    assert "all-gather" not in f.lower(Ht, sv).compile().as_text()


@pytest.mark.gpu
def test_pallas_gf2_compiled_on_gpu(gpu):
    """On the card the compiled Triton kernels equal the XLA form at the
    reference code's width."""
    rng = np.random.default_rng(11)
    B, n = 64, 1000
    H = lt.parity_check_matrix(n, 10, 9, rng=42)
    m = H.shape[0]
    perms = np.stack([rng.permutation(n) for _ in range(B)])
    Hb = H[:, perms].transpose(1, 0, 2).astype(np.uint32)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    Hp, Ht = _packed(Hb)
    ref = jax.vmap(lambda ht, sv: gf2_eliminate(ht, sv, n))(Ht, jnp.asarray(s))
    out = gf2_eliminate_pallas(Ht, jnp.asarray(s), n)
    for a, b in zip(ref[:3], out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # OSD-0 on residuals of real error patterns (in H's column space:
    # the reference code is rank-deficient, and outside it the two forms
    # may return different inconsistent corrections)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    x = (rng.random((B, n)) < 0.05).astype(np.uint32)
    resid = jnp.asarray((np.einsum("bmn,bn->bm", Hb, x) % 2).astype(np.uint32))
    ref0 = jax.vmap(lambda hp, b, r: gf2_osd0(hp, b, r, n))(Hp, jnp.asarray(bp), resid)
    out0 = gf2_osd0_pallas(Ht, resid, jnp.asarray(bp), n)
    assert np.array_equal(np.asarray(ref0), np.asarray(out0))
