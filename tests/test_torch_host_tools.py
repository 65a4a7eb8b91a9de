"""The port's host tools: the native host-math library
(bgn_torch/utils/native.py, built by g++ from csrc/hostmath_accel.cpp)
against the plain loops of bgn_torch/hostmath.py, the independent pairing
oracle (bgn_torch/hostmath2.py) against the port's hostmath and the JAX
package's hostmath2, the profiling helpers, and both demo checks of
bgn_torch/cli.py at a 64-bit key on the CPU.  No JAX kernel runs here.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import glob
import random
import re

import pytest
import torch

from bgn_torch import cli
from bgn_torch import hostmath as thm
from bgn_torch import hostmath2 as thm2
from bgn_torch import scheme as tscheme
from bgn_torch.utils import native, profiling
from bgn_tpu import hostmath2 as jhm2


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _carmichael(bits, rng):
    """A Carmichael number (6k+1)(12k+1)(18k+1), its factors prime, of
    about `bits` bits."""
    k = rng.getrandbits(bits // 3 - 7)
    while not all(thm.is_probable_prime_plain(f * k + 1)
                  for f in (6, 12, 18)):
        k += 1
    return (6 * k + 1) * (12 * k + 1) * (18 * k + 1)


@pytest.mark.parametrize("bits", [64, 200, 512, 1024])
def test_native_prime_test_matches_plain(bits):
    """Random odd numbers and primes of the size: the same verdicts."""
    rng = random.Random(bits)
    nums = [_odd(rng, bits) for _ in range(40 if bits <= 512 else 16)]
    nums += [thm.gen_prime(bits, rng) for _ in range(2)]
    for x in nums:
        assert native.is_probable_prime(x) is thm.is_probable_prime_plain(x)
    assert sum(thm.is_probable_prime(x) for x in nums) >= 2


def test_native_known_primes_and_carmichael_numbers():
    primes = [2, 3, 5, 7, 251, 257, 65537, 2 ** 61 - 1, 2 ** 89 - 1,
              2 ** 127 - 1, 2 ** 521 - 1]
    rng = random.Random(3)
    carmichael = [561, 1105, 1729, 2465, 2821, 6601, 8911, 41041, 825265,
                  321197185] + [_carmichael(b, rng) for b in (64, 200)]
    for x in primes:
        assert native.is_probable_prime(x) and thm.is_probable_prime(x), x
    for x in carmichael + [0, 1, 4, 9, 2 ** 61 + 1, (2 ** 61 - 1) ** 2]:
        assert not native.is_probable_prime(x), x
        assert not thm.is_probable_prime_plain(x), x


@pytest.mark.parametrize("bits", [64, 128, 256])
def test_native_find_cofactor_matches_plain(bits):
    rng = random.Random(bits + 1)
    for _ in range(3):
        n = thm.gen_prime(bits // 2, rng) * thm.gen_prime(bits // 2, rng)
        l = native.find_cofactor(n)
        assert l == thm.find_cofactor_plain(n) == thm.find_cofactor(n)
        assert l % 4 == 0 and thm.is_probable_prime_plain(l * n - 1)


def test_size_routes_go_to_the_plain_loops():
    """Inputs the library does not take give None, and hostmath runs its
    loop for them: wider than 72 (primality) or 70 (cofactor) words, and
    an n so small that the sieve would reject a prime l*n - 1."""
    wide = 2 ** (72 * 64 + 8) + 1        # 577 bytes, divisible by 257
    assert native.is_probable_prime(wide) is None
    assert thm.is_probable_prime(wide) is False
    assert native.find_cofactor(2 ** (70 * 64) + 3) is None
    assert native.find_cofactor(101 * 103) is None
    assert thm.find_cofactor(101 * 103) == thm.find_cofactor_plain(101 * 103)
    with pytest.raises(ValueError):
        native.is_probable_prime(-3)


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build(source=bad, build_dir=tmp_path / "out")
    assert sorted(f.name for f in (tmp_path / "out").iterdir()) == \
        ["libbgnhost.so.lock"]           # no library, no temporary file
    assert native.available()


def test_keygen_native_equals_plain(monkeypatch):
    """A 64-bit key with the native library equals one with the plain
    loops (the library's answers are the loops' on every keygen input)."""
    pk, sk = tscheme.keygen(64, 1021, rng=random.Random(5), device="cpu")
    calls = []

    def plain(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(thm, "is_probable_prime",
                        plain(thm.is_probable_prime_plain))
    monkeypatch.setattr(thm, "find_cofactor", plain(thm.find_cofactor_plain))
    pk2, sk2 = tscheme.keygen(64, 1021, rng=random.Random(5), device="cpu")
    assert "find_cofactor_plain" in calls
    assert "is_probable_prime_plain" in calls
    assert (pk.n, pk.l, pk.p, pk.P_host, pk.Q_host, sk.r) == \
        (pk2.n, pk2.l, pk2.p, pk2.P_host, pk2.Q_host, sk2.r)
    for x, y in zip(pk.dev.buffers(), pk2.dev.buffers()):
        assert torch.equal(x, y)


def test_oracle2_matches_hostmath_and_jax():
    """The independent pairing (schoolbook F_p^2, verticals kept, the
    direct final power) equals the port's hostmath.tate_pairing and the
    JAX package's hostmath2 on random keys and points; the Weil/Tate
    triangle holds."""
    rng = random.Random(20261018)
    for i, bits in enumerate([16, 20, 24, 32, 40, 48, 56, 64] * 2):
        params = thm.gen_a1_params(bits, rng)
        P = thm.random_curve_point(params, rng)
        Q = thm.random_curve_point(params, rng)
        z = thm2.tate_pairing_indep(P, Q, params)
        assert z == thm.tate_pairing(P, Q, params)
        assert z == jhm2.tate_pairing_indep(P, Q, params)
        assert thm2.tate_pairing_indep(Q, P, params) == z
        if i % 4 == 0:
            assert thm2.weil_tate_consistent(P, Q, params)
            S = thm2.phi(Q, params.p)
            assert thm2.weil_pairing(thm2.lift(P, params.p), S, params.n,
                                     params.p) == jhm2.weil_pairing(
                jhm2.lift(P, params.p), S, params.n, params.p)


def test_time_op_and_trace_on_the_cpu(tmp_path):
    x = torch.arange(1 << 12, dtype=torch.float32)
    calls = []

    def op(t):
        calls.append(1)
        return t * 2 + 1

    secs = profiling.time_op(op, x, iters=3, warmup=2)
    assert secs > 0 and len(calls) == 5
    assert profiling.time_op(op, x, iters=1, warmup=0) > 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mul(x, 3)
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    assert "aten::mul" in open(files[0]).read()
    assert any(e.key == "aten::mul" for e in prof.key_averages())


_LINE = re.compile(r"^([-()01 +*]+) = (-?\d+)$")


def test_cli_simple_check_at_64_bits(capsys):
    """Every truth-table line printed is exact: its value is the
    expression's."""
    rows = cli.run_simple_check(64, 3, seed=1, device="cpu")
    lines = [m.groups() for m in map(_LINE.match,
                                     capsys.readouterr().out.splitlines())
             if m]
    assert len(lines) == len(rows) == 18
    for (expr, val), row in zip(lines, rows):
        assert int(val) == eval(expr, {"__builtins__": {}}) == row[1] == row[2]
        assert expr == row[0]


def test_cli_poly_arithmetic_check_at_64_bits(capsys):
    """Every decrypted value lies within 1e-3 (relative) of the exact
    rational arithmetic on the plaintexts, and is the value printed."""
    rows = cli.run_poly_arithmetic_check(64, 1021, 3, 3, 0.0001, seed=1,
                                         device="cpu")
    out = capsys.readouterr().out
    assert len(rows) == 10
    for label, want, got in rows:
        assert abs(got - float(want)) <= 1e-3 * abs(float(want)), label
        assert f"E({got})" in out, label
    assert rows[0][2] == float(rows[0][1])          # c1 decrypts exactly
