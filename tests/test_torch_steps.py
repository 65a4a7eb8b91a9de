"""The per-step configuration of bgn_torch (config.BGNParams(
rns_pallas="1")) against the JAX package and against the port's default
loop configuration, on the shared 64-bit key, exactly.

1. The six step kernels' plain versions (ops/cuda_rns.py: dbl_step,
   add_step, pt_dbl, pt_add, pow_step, fp2_pow_step; the wrappers run them
   for CPU tensors) against the JAX step functions and one call of each
   JAX Pallas step kernel in interpret mode.  Residues are compared by
   value mod p (host CRT over base A) and bound: a JAX residue may read a
   value as value + p.
2. Step mode against loop mode in the port: the pairing, the G1 ladder,
   the F_p^2 power, mont_inv_rns and the fixed-base window chain
   (torch.equal); step mode must run through the step wrappers only.
3. The scheme in step mode: the split Encrypt, Mult and every op of the
   level-1 path equal the loop path's limbs and the host oracle, and every
   value decrypts.
4. BGNParams: the JAX package's fields, defaults, validation and
   to_dict(); the refused kernel modes; the applied ones.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_carry import port_public_key, port_tables
from bgn_torch import config as tconfig
from bgn_torch import scheme as tscheme
from bgn_torch.ops import cuda_rns
from bgn_torch.ops import pairing as tpairing
from bgn_torch.ops import rns_pairing as trp
from bgn_torch.utils import convert as tconvert
from bgn_tpu import config as jconfig
from bgn_tpu import hostmath as hm
from bgn_tpu.fieldcore import rns as jrn
from bgn_tpu.ops import pallas_rns
from bgn_tpu.ops import rns_pairing as jrp

LOOP_KERNELS = ("miller_loop", "pow_loop", "fp2_pow_loop", "dual_ladder",
                "ladder_loop", "window_ladder_tab", "window_ladder")
STEP_KERNELS = ("dbl_step", "add_step", "pt_dbl", "pt_add", "pow_step",
                "fp2_pow_step")


@pytest.fixture(scope="module")
def keys(shared_keypair64, shared_tables64):
    """The JAX key, the port's key, secret key and tables built from its
    arrays, and the host oracle's key."""
    jpk, jsk = shared_keypair64
    pk = port_public_key(jpk)
    sk = tscheme.BGNSecretKey(jsk.a1_params, jsk.r, jsk.poly_base)
    gk = hm.GoldenKey(params=jsk.a1_params, P=jpk.P_host, Q=jpk.Q_host,
                      R=jsk.r, msg_space=jpk.msg_space)
    return jpk, jsk, pk, sk, port_tables(shared_tables64), gk


def _step_mode(monkeypatch):
    """BGNParams(rns_pallas="1") applied; monkeypatch restores the mode."""
    monkeypatch.setattr(trp, "_PALLAS_MODE", trp._PALLAS_MODE)
    tconfig.BGNParams(rns_pallas="1").apply_kernel_modes()
    assert trp._mode() == "step"


def _values(rns, v):
    """Host ints of residues [2k, N] by CRT over base A (every value here
    is below A)."""
    k = rns.k
    mods = [int(m) for m in rns.m.reshape(-1)[:k]]
    arr = np.asarray(v).astype(np.int64)
    out = []
    for b in range(arr.shape[1]):
        acc, mod = 0, 1
        for i, mi in enumerate(mods):
            t = ((int(arr[i, b]) - acc) * pow(mod % mi, -1, mi)) % mi
            acc += mod * t
            mod *= mi
        out.append(acc)
    return out


def _same_value(p, rns, got, want, bound):
    """got (torch) and want (JAX) residues: equal mod p, got < bound * p."""
    gv, wv = _values(rns, got.numpy()), _values(rns, want)
    assert [v % p for v in gv] == [v % p for v in wv]
    assert max(gv) < bound * p


def _inputs(pk, bounds, n, seed):
    """Random values below bound * p as residues [2k, n], one array per
    bound, as numpy float32."""
    rng = random.Random(seed)
    m = pk.dev.rns.m.reshape(-1).numpy().astype(np.int64)
    out = []
    for b in bounds:
        vals = [rng.randrange(b * pk.p) for _ in range(n)]
        out.append(np.array([[v % int(mi) for v in vals] for mi in m],
                            dtype=np.float32))
    return out


def _jax_pow_body(rns, acc, x, bit):
    sq = jrn.r_mul(rns, jrn.RVal(acc, 3), jrn.RVal(acc, 3))
    mu = jrn.r_mul(rns, sq, jrn.RVal(x, 16))
    return jnp.where(bit > 0, mu.v, sq.v)


def _jax_fp2_body(rns, ar, ai, xr, xi, bit):
    sq = jrp._fp2_sqr(rns, (jrn.RVal(ar, 9), jrn.RVal(ai, 9)))
    mu = jrp._fp2_mul(rns, sq, (jrn.RVal(xr, 9), jrn.RVal(xi, 10)))
    return (jnp.where(bit > 0, mu[0].v, sq[0].v),
            jnp.where(bit > 0, mu[1].v, sq[1].v))


P3 = jrp._pt
# kernel: (input bounds, output bounds, JAX step function, JAX Pallas step
# kernel in interpret mode), both on raw residue arrays
STEPS = {
    "dbl_step": ((27, 27, 6, 9, 9, 3, 3), (27, 27, 6, 9, 9),
                 lambda r, *s: jrp._dbl_step(r, *s[:5], P3(s[5]), P3(s[6])),
                 lambda r, *s: pallas_rns.dbl_step_pallas(
                     r, *s[:5], P3(s[5]), P3(s[6]), interpret=True)),
    "add_step": ((27, 27, 6, 9, 9, 3, 3, 3, 3), (27, 27, 6, 9, 9),
                 lambda r, *s: jrp._add_step(r, *s[:5],
                                             *(P3(v) for v in s[5:])),
                 lambda r, *s: pallas_rns.add_step_pallas(
                     r, *s[:5], *(P3(v) for v in s[5:]), interpret=True)),
    "pt_dbl": ((27, 27, 6), (27, 27, 6),
               lambda r, *s: jrp._dbl_pt(r, *s),
               lambda r, *s: pallas_rns.pt_dbl_pallas(r, *s,
                                                      interpret=True)),
    "pt_add": ((27, 27, 6, 3, 3), (27, 27, 6),
               lambda r, *s: jrp._add_pt(r, *s[:3], P3(s[3]), P3(s[4])),
               lambda r, *s: pallas_rns.pt_add_pallas(
                   r, *s[:3], P3(s[3]), P3(s[4]), interpret=True)),
    "pow_step": ((3, 16), (3,),
                 lambda r, acc, x, bit: (_jax_pow_body(r, acc, x, bit),),
                 lambda r, acc, x, bit: (pallas_rns.pow_step_pallas(
                     r, acc, x, bit, interpret=True),)),
    "fp2_pow_step": ((9, 9, 9, 10), (9, 9), _jax_fp2_body,
                     lambda r, *s: pallas_rns.fp2_pow_step_pallas(
                         r, *s, interpret=True)),
}


@pytest.mark.parametrize("name", STEP_KERNELS)
def test_step_plain_versions_match_jax(keys, name):
    """Each step kernel's plain version (through its wrapper, on the CPU)
    against the JAX step function (jitted) and the JAX Pallas step kernel
    (interpret mode) at 6 lanes; pow_step and fp2_pow_step with bit 1 and
    bit 0 (the JAX kernel with bit 1)."""
    jpk, _, pk, _, _, _ = keys
    jrns, trns = jpk.dev.rns, pk.dev.rns
    in_b, out_b, jax_fn, jax_kernel = STEPS[name]
    ins = _inputs(pk, in_b, 6, 100 + STEP_KERNELS.index(name))
    wrapper = getattr(cuda_rns, name)
    bits = (1, 0) if name.endswith("pow_step") else (None,)
    for bit in bits:
        extra = () if bit is None else (bit,)
        before = wrapper.launches
        got = wrapper(trns, *(torch.tensor(a) for a in ins), *extra)
        assert wrapper.launches == before              # CPU: plain version
        got = got if isinstance(got, tuple) else (got,)
        plain = getattr(cuda_rns, name + "_plain")(
            trns, *(torch.tensor(a) for a in ins), *extra)
        plain = plain if isinstance(plain, tuple) else (plain,)
        assert all(torch.equal(g, w) for g, w in zip(got, plain))
        jins = [jnp.asarray(a) for a in ins]
        wants = [jax.jit(lambda *s: jax_fn(jrns, *s, *extra))(*jins)]
        if bit != 0:
            wants.append(jax_kernel(jrns, *jins, *extra))
        for want in wants:
            assert len(want) == len(out_b)
            for g, w, b in zip(got, want, out_b):
                _same_value(jpk.p, trns, g, w, b)


def _host_pts(pk, base, ms):
    """Host points m*base (None: the identity)."""
    return [None if m is None else hm.ec_mul(m, base, pk.p) for m in ms]


def _no_loop_kernels(monkeypatch):
    """Make every loop wrapper raise and count the step wrappers' calls."""
    calls = dict.fromkeys(STEP_KERNELS, 0)
    for name in LOOP_KERNELS:
        def refuse(*_, _n=name):
            raise AssertionError(f"{_n} called in step mode")
        monkeypatch.setattr(cuda_rns, name, refuse)
    for name in STEP_KERNELS:
        def count(*a, _n=name, _f=getattr(cuda_rns, name)):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(cuda_rns, name, count)
    return calls


def test_step_mode_equals_loop_mode(keys, monkeypatch):
    """pairing_rns, scalar_mul_rns and fp2_pow_rns (signed NAF digits of
    q1, unitary input), mont_inv_rns and fixed_base_mul_rns (e = 0 and
    first-window-identity lanes, both raw forms) give the same residues
    and limbs in both modes, and step mode goes through the step wrappers
    only.  A non-unitary F_p^2 power with a negative digit raises before
    any step."""
    jpk, jsk, pk, _, _, _ = keys
    ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
    ms = [1, 2, 7, 100, 55, 3]
    a = tconvert.affine_from_host(ctx, _host_pts(jpk, jpk.P_host, ms))
    b = tconvert.affine_from_host(ctx, _host_pts(jpk, jpk.Q_host,
                                                 [3, 5, 2, 99, 4, 6]))
    J, R = dk.p_win[0].shape[:2]
    digits = np.random.default_rng(9).integers(0, R, size=(J, 6))
    digits[:, 3] = 0
    digits[0, 2] = 0
    inv_in = a.x[:, :4]

    def run():
        z = trp.pairing_rns(ctx, rns, a, b, dk.n_naf, dk.l_bits)
        ladder = trp.scalar_mul_rns(ctx, rns, a, jsk.q1_naf)
        gt = trp.fp2_pow_rns(ctx, rns, z, jsk.q1_naf, unitary=True)
        inv = trp.mont_inv_rns(ctx, rns, inv_in)
        raw = trp.fixed_base_mul_rns(ctx, rns, dk.p_win, digits, raw=True)
        jac = trp.fixed_base_mul_rns(ctx, rns, dk.p_win, digits)
        return [z, gt, inv, *(v.v for v in ladder), *(v.v for v in raw),
                *jac]

    loop = run()
    _step_mode(monkeypatch)
    calls = _no_loop_kernels(monkeypatch)
    step = run()
    assert len(step) == len(loop)
    for u, v in zip(step, loop):
        assert torch.equal(u, v)
    assert all(calls[n] > 0 for n in STEP_KERNELS), calls
    assert torch.all(step[-4][:, 3] == 0)               # e = 0: Z = 0
    assert torch.all(step[-1][:, 3] == 0)
    with pytest.raises(ValueError, match="nonnegative digits"):
        trp.fp2_pow_rns(ctx, rns, loop[0], jsk.q1_naf, unitary=False)
    assert calls["fp2_pow_step"] == len(dk.l_bits) + len(jsk.q1_naf)


MS = [0, 1, 7, -5, 30, -4, 2, 13]
KS = [3, 0, -7, 5, 2, 6, -2, 1]
RS = [5, 6, 0, 9, 1, 2, 3, 4]


def test_scheme_step_mode_matches_loop_mode(keys, monkeypatch):
    """With BGNParams(rns_pallas="1"): Encrypt (the split path), Mult,
    EncryptDeterministic, Add, Sub, Neg, MultConst and MakeL2 give the
    loop path's limbs, Encrypt the host oracle's points, and every value
    decrypts (L2 and L1, 0 and negatives included)."""
    _, _, pk, sk, tables, gk = keys

    def ops():
        a = pk.encrypt_with_randomness(MS, RS)
        b = pk.encrypt_with_randomness(KS, RS[::-1])
        return {"Encrypt": a, "Mult": pk.mult(a, b),
                "EncryptDeterministic": pk.encrypt_deterministic(MS),
                "Add": pk.add(a, b), "Sub": pk.sub(a, b), "Neg": pk.neg(a),
                "MultConst": pk.mult_const(a, [2, 0, -3, 1, 4, -1, 0, 2]),
                "MakeL2": pk.make_l2(a)}

    loop = ops()
    _step_mode(monkeypatch)
    step = ops()
    for name, ct in step.items():
        want = loop[name]
        assert ct.level2 == want.level2
        got_t = (ct.data,) if ct.level2 else tuple(ct.data)
        want_t = (want.data,) if want.level2 else tuple(want.data)
        assert all(torch.equal(u, v) for u, v in zip(got_t, want_t)), name
    assert tconvert.affine_to_host(pk.dev.ctx, step["Encrypt"].data) == \
        [hm.golden_encrypt(gk, m, r) for m, r in zip(MS, RS)]
    expect = {"Encrypt": MS, "Mult": [m * k for m, k in zip(MS, KS)],
              "EncryptDeterministic": MS,
              "Add": [m + k for m, k in zip(MS, KS)],
              "Sub": [m - k for m, k in zip(MS, KS)],
              "Neg": [-m for m in MS],
              "MultConst": [m * c for m, c in
                            zip(MS, [2, 0, -3, 1, 4, -1, 0, 2])],
              "MakeL2": MS}
    for name, want in expect.items():
        assert list(sk.decrypt(step[name], pk, tables)) == want, name


def test_bgn_params_match_jax(monkeypatch):
    """The JAX package's fields, defaults and validation; a JAX to_dict()
    loads unchanged; the refused kernel modes raise with their reasons;
    apply_kernel_modes sets the granularity (monkeypatch restores it)."""
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.BGNParams)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.BGNParams)]
    assert tf == jf
    jp = jconfig.BGNParams(key_bits=64, msg_space=101, rns_pallas="1",
                           n_devices=1)
    assert tconfig.BGNParams.from_dict(jp.to_dict()).to_dict() == \
        jp.to_dict()
    assert tconfig.BGNParams.reference_test_config().to_dict() == \
        jconfig.BGNParams.reference_test_config().to_dict()
    for bad in ({"key_bits": 15}, {"key_bits": 63}, {"msg_space": 1},
                {"bogus": 1}):
        with pytest.raises(ValueError) as je:
            jconfig.BGNParams.from_dict(bad)
        with pytest.raises(ValueError) as te:
            tconfig.BGNParams.from_dict(bad)
        assert str(te.value) == str(je.value)

    monkeypatch.setattr(trp, "_PALLAS_MODE", trp._PALLAS_MODE)
    for name in ("_RNS_MODE", "_USE_FUSED"):
        monkeypatch.setattr(tpairing, name, getattr(tpairing, name))
    refused = [({"rns_pallas": "0"}, ValueError, "plain PyTorch"),
               ({"rns_pallas": "interpret"}, ValueError, "device=\"cpu\""),
               ({"rns_pallas": "loop-interpret"}, ValueError, "interpreter"),
               ({"rns_pallas": "2"}, ValueError, "unknown"),
               ({"rns_miller": "x"}, ValueError, "unknown"),
               ({"pallas": False}, NotImplementedError, "queue 3")]
    for fields, exc, why in refused:
        with pytest.raises(exc, match=why):
            tconfig.BGNParams(**fields).apply_kernel_modes()
        assert trp._PALLAS_MODE == "loop"
        assert tpairing._RNS_MODE == "auto" and tpairing._USE_FUSED is True
    # the limb-domain configuration and the Miller form are applied
    tconfig.BGNParams(rns_miller="0").apply_kernel_modes()
    assert tpairing._RNS_MODE == "0" and not tpairing.use_rns(object())
    tconfig.BGNParams(fused_miller=False).apply_kernel_modes()
    assert tpairing._USE_FUSED is False and tpairing._RNS_MODE == "0"
    tconfig.BGNParams(rns_miller="auto", fused_miller=True) \
        .apply_kernel_modes()
    assert tpairing.use_rns(object()) and tpairing._USE_FUSED is True
    assert tconfig.BGNParams().make_mesh() is None   # no group: 1 rank
    with pytest.raises(ValueError, match="n_devices=2"):
        tconfig.BGNParams(n_devices=2).make_mesh()
    tconfig.BGNParams(rns_miller="1", pallas=True).apply_kernel_modes()
    assert trp._mode() == "loop"
    tconfig.BGNParams(rns_pallas="1").apply_kernel_modes()
    assert trp._mode() == "step"
    tconfig.BGNParams().apply_kernel_modes()          # None keeps the mode
    assert trp._mode() == "step"
    tconfig.BGNParams(rns_pallas="loop").apply_kernel_modes()
    assert trp._mode() == "loop"
