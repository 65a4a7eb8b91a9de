#!/usr/bin/env python3
"""Time the proof-of-knowledge verify's two RNS routes on one CUDA card.

    python3 scripts/pok_routes.py [--batch 2048] [--turns 2] [--seed 1]

On a 512-bit key (n > 2^256, where check_proof_of_plaintext_knowledge
takes the fused route) it proves `batch` honest proofs of plaintext
knowledge and times, turn by turn in the order fused, reduced, reduced,
fused:
  - the fused route: gadgets._pok_verify_fused (the digest on the card
    and its 256 bits unpacked there, straight into the ct^c ladder);
  - the reduced route, the one keys with n < 2^256 take: _fiat_shamir
    (the digest on the card, read back as ints), scheme._signed_bits(cs,
    n) on the host, gadgets._pok_verify_rns_core;
each with its one readback of the packed verdicts, and each route's part
before the ladders alone (digest to challenge bits on the card).  Times
are the host clock around synchronized calls, as chip_smoke.py times its
rates.  Both routes must answer alike, every lane true and none
suspicious.  It builds the kernels from bgn_torch/csrc as chip_smoke.py
does (reusing a build that is up to date), prints the card's name and
power limit, and as its last line one JSON object of the times.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bgn_torch import _build, gadgets as gd, scheme  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pok_routes.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    rng = random.Random(args.seed)
    pk, sk = scheme.keygen(512, 1021, rng=rng, device="cuda")
    assert pk.n > 1 << 256
    B = args.batch
    vs = [rng.randrange(340) for _ in range(B)]
    zs = [rng.randrange(pk.n) for _ in range(B)]
    ct = pk.encrypt_with_randomness(vs, zs)
    proof = gd.new_proof_of_plaintext_knowledge(pk, sk, vs, zs, rng=rng)
    dev, n = pk.dev, pk.n
    dl_digits, _ = scheme._signed_digits(proof.dl, n)

    def fused_bits():
        words = gd._fs_digest(dev, proof.ct.data, proof.nonce.data)
        shifts = torch.arange(31, -1, -1, device=words.device)
        return ((words[:, :, None] >> shifts) & 1).reshape(B, 256).T

    def reduced_bits():
        cs = gd._fiat_shamir(pk, proof.ct, proof.nonce)
        return torch.as_tensor(scheme._signed_bits(cs, n)[0],
                               device=ct.data.x.device)

    def fused():
        return gd._pok_verify_fused(dev, ct.data, proof.ct.data,
                                    proof.nonce.data, dl_digits).cpu()

    def reduced():
        return gd._pok_verify_rns_core(dev, ct.data, proof.nonce.data,
                                       reduced_bits(), dl_digits).cpu()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    # first calls (allocation, the lazily built library) outside the turns
    want = fused()
    if not torch.equal(reduced(), want) or not bool((want == 1).all()):
        raise AssertionError("the routes disagree or a lane is not true")
    if not torch.equal(fused_bits().cpu(), reduced_bits().cpu()):
        raise AssertionError("the challenge bits differ between the routes")
    times = {"fused": [], "reduced": [], "fused_bits": [],
             "reduced_bits": []}
    for _ in range(args.turns):
        for route in ("fused", "reduced", "reduced", "fused"):
            out, t = timed(fused if route == "fused" else reduced)
            if not torch.equal(out, want):
                raise AssertionError(f"{route}: verdicts changed")
            times[route].append(t)
            _, t = timed(fused_bits if route == "fused" else reduced_bits)
            times[route + "_bits"].append(t)
    for name, ts in times.items():
        print(f"{name}: median {statistics.median(ts) * 1e3:.1f} ms over "
              f"{len(ts)} calls ({', '.join(f'{t * 1e3:.1f}' for t in ts)}"
              f" ms), B={B}, 512-bit key [{card}]")
    print(json.dumps({"card": card, "batch": B, "seconds": times}))


if __name__ == "__main__":
    main()
