"""Demo CLI mirroring the reference's cmd/main.go: the port's counterpart
of `bgn_tpu/cli.py`.

Runs the 0/1 truth-table check (runSimpleCheck, cmd/main.go:74-107) and the
rational-arithmetic polynomial demo (runPolyArithmeticCheck,
cmd/main.go:24-72) on one device, the card unless --device cpu:

    python -m bgn_torch.cli [--key-bits N] [--seed S] [--device cuda|cpu]

Each check prints the reference's lines and returns what it printed with
what it should be: (expression, its exact value, the decrypted value) per
line, for a caller to hold the output against.
"""

from __future__ import annotations

import argparse
import random
import time
from fractions import Fraction

BANNER = r"""
====================================
 ____   _____ _   _
|  _ \ / ____| \ | |
| |_) | |  __|  \| |
|  _ <| | |_ | . ` |
| |_) | |__| | |\  |
|____/ \_____|_| \_|

Boneh Goh Nissim Cryptosystem on CUDA (PyTorch, hand-written kernels)
====================================
"""


def run_simple_check(key_bits: int, poly_base: int, seed=None,
                     device: str = "cuda") -> list:
    """The truth table of Add, Mult and Neg on E(0), E(1) and E(-1) at
    both levels.  Returns [(expression, exact value, decrypted value)]."""
    from .config import BGNParams

    rng = random.Random(seed)
    params = BGNParams(key_bits=key_bits, msg_space=1021,
                       poly_base=poly_base, fp_scale_base=3,
                       fp_precision=2, deterministic=True)
    pk, sk = params.keygen(rng=rng, device=device)
    tables = pk.setup_decryption(sk, rng=rng)

    zero = pk.encrypt([0])
    one = pk.encrypt([1])
    negone = pk.encrypt([-1])

    def d(ct):
        return int(sk.decrypt_failsafe(ct, pk, tables)[0])

    rows = []

    def line(expr, want, ct):
        got = d(ct)
        print(f"{expr} =", got)
        rows.append((expr, want, got))

    print("\n---------RUNNING BASIC CHECK----------\n")
    line("0 + 0", 0, pk.add(zero, zero))
    line("0 + 1", 1, pk.add(zero, one))
    line("1 + 1", 2, pk.add(one, one))
    line("1 + 0", 1, pk.add(one, zero))

    line("0 * 0", 0, pk.mult(zero, zero))
    line("0 * 1", 0, pk.mult(zero, one))
    line("1 * 0", 0, pk.mult(one, zero))
    line("1 * 1", 1, pk.mult(one, one))

    line("0 - 0", 0, pk.add(zero, pk.neg(zero)))
    line("0 - 1", -1, pk.add(zero, pk.neg(one)))
    line("0 + (-1)", -1, pk.add(zero, negone))
    line("1 - 1", 0, pk.add(one, pk.neg(one)))
    line("1 - 0", 1, pk.add(one, pk.neg(zero)))

    line("0 * (-0)", 0, pk.mult(zero, pk.neg(zero)))
    line("0 * (-1)", 0, pk.mult(zero, pk.neg(one)))
    line("1 * (-0)", 0, pk.mult(one, pk.neg(zero)))
    line("1 * (-1)", -1, pk.mult(one, pk.neg(one)))
    line("(-1) * (-1)", 1, pk.mult(pk.neg(one), pk.neg(one)))
    print("\n---------DONE----------")
    return rows


def run_poly_arithmetic_check(key_bits: int, msg_space: int, poly_base: int,
                              fp_scale_base: int, fp_precision: float,
                              seed=None, device: str = "cuda") -> list:
    """Rationals as encrypted polynomials: Add, MultConst, Mult and Add of
    a Neg.  Returns [(label, exact value on the plaintexts, decrypted
    value)], the exact value a Fraction."""
    from . import encoding, polyct
    from .config import BGNParams

    rng = random.Random(seed)
    params = BGNParams(key_bits=key_bits, msg_space=msg_space,
                       poly_base=poly_base, fp_scale_base=fp_scale_base,
                       fp_precision=fp_precision, deterministic=True)
    pk, sk = params.keygen(rng=rng, device=device)
    tables = pk.setup_decryption(sk, rng=rng)

    def dec(pct):
        return polyct.decrypt_poly(sk, pct, pk, tables).poly_eval()

    m1 = encoding.new_poly_plaintext(pk, 0.0111)
    m2 = encoding.new_poly_plaintext(pk, 9.1)
    m3 = encoding.new_poly_plaintext(pk, 2.75)
    m4 = encoding.new_poly_plaintext(pk, 2.99)
    x1, x2, x3, x4 = (m.poly_eval_fraction() for m in (m1, m2, m3, m4))

    c1 = polyct.encrypt_poly(pk, m1)
    c2 = polyct.encrypt_poly(pk, m2)
    c3 = polyct.encrypt_poly(pk, m3)
    c4 = polyct.encrypt_poly(pk, m4)
    c6 = polyct.neg_poly(pk, c4)

    rows = []
    print("\n----------RUNNING ARITHMETIC TEST----------\n")
    for name, c, x in [("c1", c1, x1), ("c2", c2, x2), ("c3", c3, x3),
                       ("c4", c4, x4)]:
        got = dec(c)
        print(f"{name} = E({got})")
        rows.append((name, x, got))
    print()

    r1 = polyct.add_poly(pk, c1, c4)
    got = dec(r1)
    print(f"[Add] E({m1}) + E({m4}) = E({got})\n")
    rows.append(("Add", x1 + x4, got))

    r2 = polyct.mult_const_poly(pk, c2, 10.0)
    got = dec(r2)
    print(f"[MultConst] E({m2}) * 10.0 = E({got})\n")
    rows.append(("MultConst 10.0", x2 * 10, got))

    r3 = polyct.mult_poly(pk, c3, c4)
    dr3 = dec(r3)
    print(f"[Mult] E({m3}) * E({m4}) = E({dr3})\n")
    rows.append(("Mult", x3 * x4, dr3))

    r4 = polyct.mult_const_poly(pk, r3, 0.5)
    got = dec(r4)
    print(f"[MultConst] E({dr3}) * 0.5 = E({got})\n")
    rows.append(("MultConst 0.5", x3 * x4 * Fraction(1, 2), got))

    r5 = polyct.add_poly(pk, r3, r3)
    got = dec(r5)
    print(f"[Add] E({dr3}) + E({dr3}) = E({got})\n")
    rows.append(("Add Mult", 2 * x3 * x4, got))

    r6 = polyct.add_poly(pk, c1, c6)
    got = dec(r6)
    print(f"[Add] E({m1}) + Neg(E({m4})) = E({got})\n")
    rows.append(("Add Neg", x1 - x4, got))

    print("\n----------DONE----------")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="bgn_torch demo")
    ap.add_argument("--key-bits", type=int, default=512,
                    help="length of q1 and q2 (reference default: 512)")
    ap.add_argument("--msg-space", type=int, default=1021)
    ap.add_argument("--poly-base", type=int, default=3)
    ap.add_argument("--fp-scale-base", type=int, default=3)
    ap.add_argument("--fp-precision", type=float, default=0.0001)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    print(BANNER)
    t0 = time.time()
    run_simple_check(args.key_bits, args.poly_base, seed=args.seed,
                     device=args.device)
    run_poly_arithmetic_check(args.key_bits, args.msg_space, args.poly_base,
                              args.fp_scale_base, args.fp_precision,
                              seed=args.seed, device=args.device)
    print(f"\ntotal wall time: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
