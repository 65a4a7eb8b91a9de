"""The limb-domain pairing of bgn_torch (config.BGNParams(rns_miller="0"))
against the JAX package, exactly, on the shared 64-bit key (L = 6, 2L = 12
digits), inputs from a numpy seed.

1. ops/cuda_pairing.py: to_digits / from_digits against the JAX ones; the
   plain versions of the two digit-domain Miller step kernels (dbl_step,
   add_step; the wrappers run them for CPU tensors) against one call of
   each JAX Pallas kernel (bgn_tpu/ops/pallas_pairing.py) in interpret
   mode, and along a chain of steps against the JAX limb formulas
   (_dbl_with_line / _madd_with_line and the F_p^2 f-update).
2. ops/pairing.py: miller_loop_fused (through the step wrappers) and the
   limb miller_loop against the JAX miller_loop; the limb-mode pairing(),
   fused and not, against the JAX package's limb pairing (its
   final_exponentiation of that miller_loop; its pairing() on the CPU)
   and the port's RNS pairing, identity lanes included.

Every comparison is exact: each value is a canonical residue.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key
from bgn_torch.ops import cuda_pairing
from bgn_torch.ops import pairing as tpairing
from bgn_torch.utils import convert as tconvert
from bgn_tpu import hostmath as hm
from bgn_tpu.ops import curve as jcurve
from bgn_tpu.ops import fp2 as jfp2
from bgn_tpu.ops import pairing as jpairing
from bgn_tpu.ops import pallas_pairing

SEED = 11


@pytest.fixture(scope="module")
def keys(shared_keypair64):
    jpk, _ = shared_keypair64
    return jpk, port_public_key(jpk)


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _jnp(t):
    """The JAX array of a port tensor (limbs as uint32, digits float32)."""
    a = t.cpu().numpy()
    return jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64 else a)


def _same(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _points(pk, rng, n, identity=0):
    """n host multiples of P (the first `identity` of them the identity),
    as the port's AffinePoint [L, n]."""
    p = pk.p
    pts = [None] * identity + [hm.ec_mul(int(k) % pk.n, pk.P_host, p)
                               for k in rng.integers(1, 2 ** 62, n - identity)]
    return tconvert.affine_from_host(pk.dev.ctx, pts)


def _randmod(pk, rng, n):
    """[L, n] canonical residues (random Montgomery-form values)."""
    vals = [int(v) % pk.p for v in rng.integers(0, 2 ** 62, n)]
    return tconvert.affine_from_host(pk.dev.ctx, [(v, 0) for v in vals]).x


def test_digit_conversions_match_jax(keys):
    _, pk = keys
    rng = np.random.default_rng(SEED)
    limbs = torch.as_tensor(rng.integers(0, 1 << 16, (pk.dev.ctx.L, 3, 5)))
    d = cuda_pairing.to_digits(limbs)
    assert d.dtype == torch.float32
    _same(d, pallas_pairing.to_digits(_jnp(limbs)))
    back = cuda_pairing.from_digits(d)
    assert torch.equal(back, limbs)
    np.testing.assert_array_equal(_u32(back),
                                  np.asarray(pallas_pairing.from_digits(
                                      _jnp(d))))


def _initial_state(pk, rng, n=8, identity=2):
    """Miller inputs: A (identity lanes first), B, V = A with Z = 1 and a
    random f, all as digits [2L, n]."""
    ctx, D = pk.dev.ctx, cuda_pairing.to_digits
    a = _points(pk, rng, n, identity)
    b = _points(pk, rng, n)
    one = ctx.one[:, None].expand(ctx.L, n)
    V = (D(a.x), D(a.y), D(one))
    f = (D(_randmod(pk, rng, n)), D(_randmod(pk, rng, n)))
    return V, f, (D(a.x), D(a.y)), (D(b.x), D(b.y))


def test_steps_match_interpreted_pallas(keys):
    """One call of each JAX Pallas step kernel (interpret mode) on a state
    one doubling in (Z != 1), identity lanes (x = y = 0) included."""
    jpk, pk = keys
    rng = np.random.default_rng(SEED + 1)
    V, f, A, Bq = _initial_state(pk, rng)
    V, f = cuda_pairing.dbl_step_plain(pk.dev.ctx, V, f, Bq)
    jV, jf, jA, jB = (tuple(map(_jnp, t)) for t in (V, f, A, Bq))
    jctx = jpk.dev.ctx
    for got, want in (
            (cuda_pairing.dbl_step_plain(pk.dev.ctx, V, f, Bq),
             pallas_pairing.dbl_step(jctx, jV, jf, jB, interpret=True)),
            (cuda_pairing.add_step_plain(pk.dev.ctx, V, f, A, Bq),
             pallas_pairing.add_step(jctx, jV, jf, jA, jB, interpret=True))):
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            _same(g, w)


@jax.jit
def _jax_dbl(ctx, v, f, xb, yb):
    v, line = jpairing._dbl_with_line(ctx, v, xb, yb)
    return v, jfp2.mul(ctx, jfp2.sqr(ctx, f), line)


@jax.jit
def _jax_add(ctx, v, f, a, xb, yb):
    v, line = jpairing._madd_with_line(ctx, v, a, xb, yb)
    return v, jfp2.mul(ctx, f, line)


def test_steps_match_jax_limb_formulas(keys):
    """A chain dbl, add, dbl, dbl, add of the plain steps against the JAX
    limb formulas: _dbl_with_line then f^2 * line, _madd_with_line then
    f * line."""
    jpk, pk = keys
    jctx, ctx = jpk.dev.ctx, pk.dev.ctx
    rng = np.random.default_rng(SEED + 2)
    V, f, A, Bq = _initial_state(pk, rng, n=6, identity=1)
    L = cuda_pairing.from_digits
    ja, jb = (tuple(_jnp(L(d)) for d in t) for t in (A, Bq))
    for op in ("dbl", "add", "dbl", "dbl", "add"):
        jv = jcurve.JacPoint(*(_jnp(L(d)) for d in V))
        jfv = jfp2.make(*(_jnp(L(d)) for d in f))
        if op == "dbl":
            V, f = cuda_pairing.dbl_step_plain(ctx, V, f, Bq)
            jv, jfv = _jax_dbl(jctx, jv, jfv, *jb)
        else:
            V, f = cuda_pairing.add_step_plain(ctx, V, f, A, Bq)
            jv, jfv = _jax_add(jctx, jv, jfv,
                               jcurve.AffinePoint(*ja, None), *jb)
        for got, want in zip(V + f, tuple(jv) + (jfv[0], jfv[1])):
            _same(L(got), want)


@pytest.fixture(scope="module")
def ciphertexts(keys):
    """Encryptions (port limbs) of random m, two of them m = 0 (the
    identity), and the JAX AffinePoints of the same limbs."""
    _, pk = keys
    rng = np.random.default_rng(SEED + 3)
    a, b = _points(pk, rng, 8, identity=1), _points(pk, rng, 8)
    b = tconvert.affine_from_host(
        pk.dev.ctx, tconvert.affine_to_host(pk.dev.ctx, b)[:7] + [None])

    def jax_pt(pt):
        return jcurve.AffinePoint(*(_jnp(t) for t in pt))

    return a, b, jax_pt(a), jax_pt(b)


@pytest.fixture(scope="module")
def jax_miller(keys, ciphertexts):
    """The JAX package's limb miller_loop on the ciphertexts (one eager
    call: its scan compiles anew at every call)."""
    jpk, _ = keys
    _, _, ja, jb = ciphertexts
    return jpairing.miller_loop(jpk.dev.ctx, ja, jb, jpk.dev.n_bits)


def test_miller_loops_match_jax(keys, ciphertexts, jax_miller):
    """f_{n,A}(phi(B)) of the fused loop (the step wrappers' plain
    versions) and of the limb loop equal the JAX limb miller_loop on the
    non-identity lanes."""
    _, pk = keys
    a, b, _, _ = ciphertexts
    want = np.asarray(jax_miller)[..., 1:7]
    for loop in (tpairing.miller_loop_fused, tpairing.miller_loop):
        got = loop(pk.dev.ctx, a, b, pk.dev.n_bits)
        np.testing.assert_array_equal(_u32(got)[..., 1:7], want)


@pytest.fixture(scope="module")
def reference_pairings(keys, ciphertexts, jax_miller):
    """The port's RNS pairing of the ciphertexts, and the JAX package's
    limb pairing (its final_exponentiation of its miller_loop; pairing()
    on the CPU, before the select of 1 on the identity lanes)."""
    jpk, pk = keys
    a, b, _, _ = ciphertexts
    d = pk.dev
    rns_z = tpairing.pairing(d.ctx, a, b, d.n_bits, d.l_bits, rns=d.rns,
                             n_naf=d.n_naf)
    jax_z = jpairing.final_exponentiation(jpk.dev.ctx, jax_miller,
                                          jpk.dev.l_bits)
    return rns_z, np.asarray(jax_z)


@pytest.mark.parametrize("fused", [True, False])
def test_limb_pairing_matches_jax_and_rns(keys, ciphertexts,
                                          reference_pairings, monkeypatch,
                                          fused):
    """pairing() under rns_miller="0" (the fused loop or the limb loop)
    against the port's RNS pairing and the JAX package's limb pairing;
    e(O, X) = e(X, O) = 1."""
    _, pk = keys
    a, b, _, _ = ciphertexts
    rns_z, jax_z = reference_pairings
    d = pk.dev
    monkeypatch.setattr(tpairing, "_RNS_MODE", "0")
    monkeypatch.setattr(tpairing, "_USE_FUSED", fused)
    z = tpairing.pairing(d.ctx, a, b, d.n_bits, d.l_bits, rns=d.rns,
                         n_naf=d.n_naf)
    assert torch.equal(z, rns_z)
    np.testing.assert_array_equal(_u32(z)[..., 1:7], jax_z[..., 1:7])
    one = tconvert.fp2_to_host(d.ctx, z[:, :, [0, 7]])
    assert one == [(1, 0), (1, 0)]
