#!/usr/bin/env python3
"""Drive the bgn_torch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--batch 8192] [--decrypt-batch 2048] [--seed 1]
                          [--wide-batch 512] [--big-batch 16]
                          [--limb-batch 64]

Phases, each of which raises on failure (the script then exits nonzero):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the build of every kernel in bgn_torch/csrc with nvcc's -Xptxas -v
     report (registers, shared memory, spills) for every instantiation of
     the RNS kernels, S = 4 slots (k <= 64), S = 6 (k <= 96) and S = 12
     (k <= 192, the extension matrices in device memory), mont_mul (the
     register kernels for W = 17, 33, 65 and 129 words, G threads per
     lane, and the local-memory loop for any other L) and the two
     digit-domain Miller step kernels (the register form for W = 17 and
     32 words, G threads per lane, and the loop form for any other L);
     the count of
     tensor-core IMMA instructions in the SASS of the fourteen RNS
     kernels, every one on the tensor-core product (TC_KERNELS: blocks of
     G lanes, base extensions on the tensor cores: csrc/rns_tc.cuh) for
     each S, which must be > 0, and their shared memory per block;
     meanwhile a spawned child process builds phase 4e's 2048-bit key on
     the host (keygen_2048);
  2. keys: 512-bit key, message space 1021, seeded, on the card, plus the
     decryption tables; then the wait for the child, so that no phase
     timed on the host clock shares the host with it;
  3. kernels: each of the seven RNS loop kernels and the six step
     kernels at the shapes the paths give it (the step kernels at
     N = batch, dbl_step, add_step, pt_dbl and pt_add also at
     N = batch - 1, decrypt-batch and 1, pow_step and fp2_pow_step also
     at N = batch - 1, decrypt-batch, 7 and 1, ragged and short blocks of
     G lanes, at every key size; pt_add also from a window chain's start
     state (X = Y = 0, Z = one) and both G1 steps on identity-base lanes;
     fp2_pow_step also from an F_p^2 chain's start (one, 0) and with the
     conjugate operand of a -1 digit;
     dual_ladder at N = batch, batch - 1, decrypt-batch (the decryption
     proofs of phase 4j) and 1, its first lanes m = 0, r = 0, m < 0 and
     the identity m = r = 0, whose Z must be 0, and on phase 2's key at
     the proof-of-knowledge prover's shape (m < n: one batch of
     decrypt-batch lanes of m < 340 with r < n, then as many nonces
     m < n with r = 0) at N = 2 decrypt-batch, 2 decrypt-batch - 1 and 1;
     window_ladder_tab at N = batch, batch - 1 and 1 on P's table over
     m < 340 and m < n (the latter also at N = decrypt-batch and 8, the
     proof-of-knowledge verify's P^DL in phase 4j), its first lanes m = 0
     (the identity), 256 and 255 (one live window), also on all-zero
     digits (E_det(0)) and on Q's table, Z = 0 exactly where no window is
     live; window_ladder
     (on no path) at N = batch, batch - 1 and 1 on streams gathered from
     P's table: window_ladder_tab's m < n and m < 340 digits (equal to
     window_ladder_tab too), every window dead, and whole blocks of G
     lanes dead at a third of the windows, the dead rows of the last two
     nonzero, and at N = batch the all-zero digits' rows (E_det(0)), Z = 0
     exactly where no window is live (every output 0 on the all-dead
     streams);
     miller_loop also at N = batch - 3 and N = 1, a ragged last block; ladder_loop with three identity-base
     lanes, also at N = decrypt-batch - 3; pow_loop also at N = batch - 3,
     64, 7, 2, short last blocks of lanes on zeros, each timed, and at
     N = 1 the time per product of the lone chain), and mont_mul at L = 34
     (N = 8192, also with a broadcast R^2 operand, and at N = 1 and 8191),
     L = 66, L = 130, L = 258 (a 4096-bit modulus, the widest; N = 512)
     and the odd L = 35 (N = 512), the local-memory loop also at the four
     even L, against its plain PyTorch version on the same inputs
     (torch.equal: the kernels are exact integer arithmetic), with the
     kernel's and the plain version's times (CUDA events); then a chain
     of step-kernel launches (the per-step configuration's host loop)
     against each loop kernel's output, bit for bit; the digit-domain
     Miller steps (miller_dbl_digits, miller_add_digits) at L = 34 on the
     512-bit key's Miller state at N = batch, batch - 1 and 1, and at
     L = 64 (the widest the fused dispatch sends, 2L + 1 = 129) at N = 512
     over random canonical digits modulo a 1000-bit prime (the register
     form), and in the loop form at L = 35 (a 540-bit prime) and L = 6 (a
     64-bit prime) at N = 512; at the synthesized 64-bit key of phase
     4j's conformance vectors, dual_ladder at N = 8, 7 and 1 over the
     vectors' (m, r) and pow_loop at N = 7 and 1; the exit conversion
     rns_exit (both halves in one launch: to_rns_mont's outputs, whose
     limbs it must give back, first lanes 0, 1 and p - 1, and their
     doubles) against its plain version, the torch-op exit, at N = batch
     (512-bit), and in 4c at N = EXIT_N_1024 and in 4e at N = big-batch;
  4. the main path end to end: Encrypt (batch of m < 340 and k in
     {1, 2, 3}) -> Mult -> DecryptL2 (decrypt-batch lanes at a time, every
     lane of the batch), every decrypted value checked against m*k and a
     few lanes against the host oracle (hostmath); each kernel of the path
     must be launched during this phase;
  4b. the level-1 path end to end on phase 4's ciphertexts: Add, Sub,
     Neg, MultConst (L1), EncryptDeterministic, MakeL2 and MultConst of
     the L2 product by +-1, every lane decrypted and checked, a few lanes
     against hostmath; each kernel of the path must be launched;
  4c. a 1024-bit key (the JAX package's bench config 5, k = 90: the S = 6
     kernels): every kernel against its plain version at N = 64, then
     Encrypt -> Mult -> DecryptL2 and Encrypt -> Add -> Decrypt at
     wide-batch lanes, every lane checked;
  4d. the limb path: a non-deterministic 512-bit key, every op
     re-randomized (Q^r, e(Q, Q)^r on limbs through mont_mul): Encrypt ->
     Mult -> L2 Add and Sub of two products -> DecryptL2; L1 Add, Sub,
     Neg, MultConst -> Decrypt; MultConst by n - 1 (the complete limb
     ladder) -> -m; MultConst L2; encrypt_device with a seeded generator.
     Every lane decrypted and checked, a few lanes against hostmath with
     the same r replayed; mont_mul must be launched; ops/s of a first and
     a second call (of one call for ONE_CALL_4D);
  4e. a 2048-bit key (k = 184 at seed 1: the S = 12 kernels; loaded from
     the child process of phase 2 and moved to the card): every RNS
     kernel against its plain version at N = big-batch over 32-digit
     strings, then Encrypt -> Mult -> DecryptL2 at big-batch lanes, every
     lane checked;
  4f. the per-step configuration, BGNParams(rns_pallas="1"), on phase 2's
     key: Encrypt (the split path) -> Mult -> DecryptL2 at batch lanes,
     Encrypt and Mult torch.equal to phase 4's outputs on the same inputs;
     EncryptDeterministic, Add, Sub, Neg, MultConst, MakeL2 -> Decrypt at
     decrypt-batch lanes; every lane checked; each step kernel must be
     launched and the five loop-only kernels must not; ops/s of a first
     and a second call; every path's launches of each wrapper with a
     `launches_by_n` (or `launches_by_jd`) dict are printed split by N
     (or by window count);
  4g. the limb-domain configuration, BGNParams(rns_miller="0"), on phase
     2's key: Encrypt -> Mult (the fused Miller loop through the two digit
     kernels) at batch lanes on phase 4's inputs, Encrypt and Mult
     torch.equal to phase 4's outputs, -> DecryptL2 of the first
     decrypt-batch lanes; EncryptDeterministic,
     Add, Sub, Neg, MultConst (L1 with negative k, L2), MakeL2 and the L1
     decrypt at decrypt-batch lanes, each torch.equal to the default
     configuration's output on the same inputs; phase 4d's
     non-deterministic key at limb-batch lanes (the same r, so equal to
     phase 4d's lanes); the fused Miller loop torch.equal to
     fused_miller=False at limb-batch lanes; phase 4c's 1024-bit key
     (L = 66: the limb Miller loop through mont_mul) at limb-batch lanes,
     Mult torch.equal to phase 4c's; every lane decrypted and checked;
     the digit-step launches of one Mult checked against the bits of n;
     no RNS kernel launched in the phase; ops/s of a first and second
     call;
  4h. phase 2's key rebuilt with its RNS context withheld (as for a key
     beyond the RNS prime pool or above k = 192: scheme._make_rns gives
     None), in the default configuration: Encrypt -> Mult -> DecryptL2 at
     limb-batch lanes, Encrypt and Mult torch.equal to phase 4g's
     limb-mode outputs on the same inputs, every lane decrypted, no RNS
     kernel launched;
  4i. the poly path on phase 2's key after a round trip of its public
     key through JSON (public_key_from_json on the card, every tensor
     equal): encode and encrypt_poly_batch POLY_B = 512 values of 100.1
     (balanced degree 13, scale 8), 1024 of 7.0 and 1024 seeded
     integers below 340; the 100.1 batch through bytes (validated, equal);
     AddPoly, SubPoly, NegPoly, MultConstPoly by 1.0 and -2.5, MultPoly
     (13 x 13 pairs per poly in one Mult), MakePolyL2 and AddPoly at L2,
     EvalPoly of the 7.0 and integer batches; the results through bytes
     again; every coefficient of every lane decrypted (decrypt-batch
     lanes at a time; of the results of the ops on the 100.1 batch, whose
     polys are all alike, the first POLY_CHECK polys) against the host
     convolution / sum / scaling of
     the plaintext coefficients and every poly decoded from them against
     its value at %.1f; the 100.1 batch and MultPoly's result also
     through decrypt_poly_batch, each returned PolyPlaintext checked the
     same way; lanes against hostmath; polys/s of a first and a second
     call; the models: encrypted_dot at DOT_D = 64, DOT_B = 128
     (x, y < 4) torch.equal to Mult + aggregate and decrypted, aggregate
     at L1, weighted_aggregate on phase 4d's non-deterministic key
     (re-randomized, decrypted); every kernel of the path must be
     launched (POLY_PATH);
  4j. the Go reference's wire format and the ZK gadgets: phase 2's public
     key through public_key_to_gob -> public_key_from_gob on the card
     (every part and tensor equal; key_bits is n's bit length), then
     decrypt-batch L1 lanes of phase 4's Encrypt output, as many L2 lanes
     of its Mult output and GOB_POLYS polys of phase 4i's 100.1 batch
     through gob, each torch.equal to what went in and decrypted right;
     the synthesized 64-bit conformance vectors verified with the device
     check on the card (7 encryption vectors, 7 op vectors, 7 device
     encryptions byte-equal); on phase 2's key at decrypt-batch lanes of
     phase 4's (m, r): decryption proofs (all true, a tampered randomness
     false), proofs of plaintext knowledge proved and verified on the
     fused RNS route in one verify (every honest lane true, the limb
     fallback not run; a tampered DL, a swapped nonce and a swapped
     ciphertext false), every device Fiat-Shamir digest equal to
     hashlib's over serialize.point_bytes, and a small batch with an
     identity nonce that goes to the limb verify at once (its answers
     the truth); proofs/s and digests/s, and 4j's seconds by part;
     window_ladder_tab, pow_loop, mont_mul and dual_ladder must be
     launched (GADGET_PATH);
  4k. the parallel layer on an NCCL group of world size 1
     (parallel.multihost.initialize on a tcp store of a free local port;
     process_info, the global mesh, BGNParams().make_mesh() None, a data
     and a stage mesh): encrypt_sharded and mult_sharded on decrypt-batch
     lanes torch.equal to the unsharded ops, replicate(pk.dev) leaving
     every buffer equal; decrypt_g1_sharded and decrypt_gt_sharded on
     decrypt-batch lanes of phase 4 and extra lanes (m = 0, negatives, an
     L2 lane out of range) equal to decrypt_with_status, on the RNS route
     and on the limb route of phase 4h's key; pairing_pipeline (one stage,
     4 microbatches) torch.equal to pairing_rns over the bits of n on all
     batch lanes of phase 4, each decrypted to m*k; every kernel of the
     path launched (PARALLEL_PATH: dbl_step and add_step from the
     pipeline); profiling.time_op of one sharded L2 decrypt and a
     profiling.trace of one microbatch that names the dbl_step kernel;
     cli.run_simple_check and run_poly_arithmetic_check at 512 bits
     (every truth-table line exact, every poly value within 1e-3 of the
     plaintexts' arithmetic); the native find_cofactor against the plain
     loop, and the host keygen seconds of the 512-, 1024- and 2048-bit
     keys;
  5. one call of each op under torch.profiler (the re-randomized Mult and
     L2 Add, the step-mode Mult, Encrypt and both decrypts, and the
     limb-mode Mult and Encrypt included): device busy time, idle share,
     the costliest device kernels, the wrappers' launches and the host's
     cudaFuncSetAttribute and cudaLaunchKernel calls; then the host
     microseconds per launch of each step wrapper at N = 1 (the median of
     seven rounds of 40 launches); MultPoly (POLY_B polys of 100.1),
     its GT accumulation alone and encrypted_dot, each with its kernels'
     launches and time beside the torch-op glue's device ops and time.
The line before the last is one JSON object {"kernels": [...]} (times,
launches, bounds; one row per TPU kernel, 17 in all, mont_mul's under
both TPU forms it replaces); the last line is {"ok": true, "device":
{...}}.
There is no CPU path: without a CUDA device the script exits nonzero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import subprocess
import sys
import time
from pathlib import Path

# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_INT8_S = 1979e12      # tensor cores, 8-bit integer operands
# 32-bit integer multiply-adds per second: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the Hopper white paper's 33.5 INT32 TOPS counts a
# multiply-add as two operations).
PEAK_INT32_MAD_S = 16.7e12


def mont_mads(L: int) -> int:
    """32-bit multiply-adds of one Montgomery product of L 16-bit limbs
    (R = 2^(16L)): the least a CIOS needs, run on ceil(L/2) 32-bit limbs
    (the same R for even L), 2 ceil(L/2)^2 wide products of two
    instructions each (low and high halves)."""
    return 4 * ((L + 1) // 2) ** 2
# ~50 ms of the card's clock (1.98 GHz): covers the host's enqueue of 50
# step-kernel launches
SLEEP_CYCLES = 100_000_000

# Elementwise operations per lane of the exact integer form of the RNS
# product (csrc/rns_tc.cuh r_mul_tc), the least the function needs on
# this card: a _red is 7 ops (mul, floor, mul, sub, compare, sub, select);
# an r_mul is 66 ops per base channel (k of them): products + reductions
# 16k, qhat 8k, the u8 lo/hi splits of the two extensions' sources 4k,
# the two extension combines (the plane sums, + KC*m - alpha*(p mod b),
# one mod: 9 per channel each) 18k, the base-B sum 9k + 3k, rhat 8k; an
# r_add is 4 ops per channel (2k channels), an r_sub 8.  Each counts at
# the fp32 rate, the integer ones too (the faster rate, so the bound
# stays a least time).  The base extensions are two [k+1, k] x [k]
# products per r_mul (the extra row: the alpha sum), each four u8 plane
# products (2 ops per multiply-add), at the int8 tensor-core peak.  (The
# TPU's fp32 form needs 96 ops per channel and two [3k+1, 2k] products:
# fp32 sums are exact only over 6-bit splits and three-piece combines.)
STEP_COUNTS = {            # (r_mul, r_add, r_sub) per step, from the code
    "r_mul": (1, 0, 0),
    "dbl_step": (21, 14, 9),
    "add_step": (17, 3, 11),
    "dbl_pt": (9, 9, 4),
    "add_pt": (11, 0, 7),
    "jac_add_full": (16, 0, 7),
    "fp2_sqr": (2, 2, 1),
    "fp2_mul": (3, 2, 3),
}

REPLACES = {
    "miller_loop": "bgn_tpu/ops/pallas_rns.py:314",
    "pow_loop": "bgn_tpu/ops/pallas_rns.py:394",
    "fp2_pow_loop": "bgn_tpu/ops/pallas_rns.py:439",
    "dual_ladder": "bgn_tpu/ops/pallas_rns.py:675",
    "ladder_loop": "bgn_tpu/ops/pallas_rns.py:359",
    "window_ladder_tab": "bgn_tpu/ops/pallas_rns.py:536",
    "window_ladder": "bgn_tpu/ops/pallas_rns.py:715",
    "dbl_step": "bgn_tpu/ops/pallas_rns.py:104",
    "add_step": "bgn_tpu/ops/pallas_rns.py:110",
    "pt_dbl": "bgn_tpu/ops/pallas_rns.py:135",
    "pt_add": "bgn_tpu/ops/pallas_rns.py:152",
    "pow_step": "bgn_tpu/ops/pallas_rns.py:223",
    "fp2_pow_step": "bgn_tpu/ops/pallas_rns.py:228",
    # one integer kernel for both TPU forms (mont_mul_pallas_f32 and
    # mont_mul_pallas, :190): the TPU split them only to avoid int32
    # multiplies
    "mont_mul": "bgn_tpu/fieldcore/pallas_mont.py:127",
    "miller_dbl_digits": "bgn_tpu/ops/pallas_pairing.py:329",
    "miller_add_digits": "bgn_tpu/ops/pallas_pairing.py:355",
}
# the row of mont_mul_pallas (:190): the same kernel and numbers as
# mont_mul's row, under the TPU kernel it also replaces
MONT_U32 = ("mont_mul (mont_mul_pallas form)",
            "bgn_tpu/fieldcore/pallas_mont.py:190")
# kernels each main path must launch (window_ladder is on no path: the
# JAX package has no caller of window_ladder_pallas either)
MAIN_PATH = ("miller_loop", "pow_loop", "fp2_pow_loop", "dual_ladder")
L1_PATH = ("ladder_loop", "window_ladder_tab", "pow_loop", "miller_loop",
           "fp2_pow_loop")
LIMB_PATH = ("mont_mul", "dual_ladder", "miller_loop", "pow_loop",
             "fp2_pow_loop", "ladder_loop")
# the per-step configuration: every step kernel, and none of the loop
# kernels that it replaces (pow_loop stays in the BSGS batch inversion,
# as in the JAX package; mont_mul in the split Encrypt's limb madd)
STEP_PATH = ("dbl_step", "add_step", "pt_dbl", "pt_add", "pow_step",
             "fp2_pow_step")
LOOP_ONLY = ("miller_loop", "fp2_pow_loop", "ladder_loop", "dual_ladder",
             "window_ladder_tab")
# the limb-domain configuration: the digit-domain Miller steps and
# mont_mul, and none of the 14 RNS kernels
DIGIT_PATH = ("miller_dbl_digits", "miller_add_digits", "mont_mul")
# the poly path, its serialization and the models (phase 4i): the
# kernels of Encrypt (dual_ladder), Mult (miller_loop, pow_loop,
# fp2_pow_loop), Neg's E_det(0) (window_ladder_tab), the L1 decrypt
# (ladder_loop) and the limb F_p^2 products of the GT accumulator (mont_mul)
POLY_PATH = ("miller_loop", "pow_loop", "fp2_pow_loop", "dual_ladder",
             "window_ladder_tab", "ladder_loop", "mont_mul")
# phase 4j (the Go wire format, conformance and the gadgets): the kernels
# of Encrypt (dual_ladder, normalize's pow_loop), the verify's P^DL
# (window_ladder_tab) and the digest's Montgomery exit and the limb
# fallback (mont_mul); GOB_POLYS polys of the 100.1 batch through gob
GADGET_PATH = ("window_ladder_tab", "pow_loop", "mont_mul", "dual_ladder")
# phase 4k (the parallel layer at world size 1): encrypt_sharded
# (dual_ladder), mult_sharded (miller_loop, pow_loop, fp2_pow_loop), the
# sharded decrypts (ladder_loop, fp2_pow_loop, pow_loop; the limb route and
# the per-rank offsets on mont_mul) and the pipeline (dbl_step, add_step,
# and pow_loop, fp2_pow_loop in its final exponentiation)
PARALLEL_PATH = ("dual_ladder", "miller_loop", "pow_loop", "fp2_pow_loop",
                 "ladder_loop", "mont_mul", "dbl_step", "add_step")
GOB_POLYS = 4
# phase 4i's shapes: POLY_B polys per batch (bench.py's bench_poly_batched),
# encrypted_dot over DOT_D coordinates of DOT_B vectors
POLY_B = 512
DOT_D, DOT_B = 64, 128
# the exit conversion's lanes at the 1024-bit key: the bgn1024-det.mult
# benchmark cell's batch
EXIT_N_1024 = 2112
# polys decrypted of each op's result on the 100.1 batch (all B alike);
# the batch itself, MultPoly's result and the 7.0 and integer batches
# are decrypted whole
POLY_CHECK = 128
# phase 4d's ops timed in one call only, no second (5-14 s each on the
# limbs; phase 4j's time): the rest keep their second call
ONE_CALL_4D = ("AddL2", "SubL2", "MultConst n-1", "MultConstL2")
# the kernels on rns_tc.cuh's tensor-core product (every RNS kernel):
# phase 1 counts their IMMA instructions
TC_KERNELS = ("miller_loop", "ladder_loop", "pow_loop", "fp2_pow_loop",
              "dual_ladder", "window_ladder_tab", "window_ladder",
              "dbl_step", "add_step", "pt_dbl", "pt_add", "pow_step",
              "fp2_pow_step", "rns_exit")
# lanes per block of the tensor-core kernels (rns_tc.cuh TcLanes<S>::G)
TC_G = 8
# the launch splits a wrapper may keep beside its count: by N, and
# (window_ladder_tab) by the number of windows Jd
SPLITS = ("launches_by_n", "launches_by_jd")


def log(msg: str) -> None:
    print(msg, flush=True)


def ops_of(k: int, counts: dict) -> tuple:
    """(elementwise ops, extension-matmul ops on u8 operands) of one
    lane."""
    n_mul = n_add = n_sub = 0
    for step, times in counts.items():
        m, a, s = STEP_COUNTS[step]
        n_mul += m * times
        n_add += a * times
        n_sub += s * times
    elem = n_mul * 66 * k + (n_add * 4 + n_sub * 8) * 2 * k
    mm = n_mul * 2 * 4 * 2 * (k + 1) * k
    return elem, mm


def bound(elem_total: float, mm_total: float, nbytes: float,
          int_mads: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rates."""
    t = {"bytes": nbytes / PEAK_BYTES_S,
         "operations": max(elem_total / PEAK_FP32_S, mm_total / PEAK_INT8_S,
                           int_mads / PEAK_INT32_MAD_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def cuda_ms(fn, torch, budget_ms: float = 1500.0) -> float:
    """Mean ms of fn() over repeated launches (CUDA events, warmed up; up
    to 50 launches or about budget_ms).  A sleep kernel queued ahead of the
    timed launches lets the host enqueue them while the card waits, so a
    short kernel is timed at the card's rate, not at the host's launch
    rate; a wrapper that synchronizes (the window kernels' digit checks)
    still adds its host time."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    one = e0.elapsed_time(e1)
    reps = max(1, min(50, int(budget_ms / max(one, 1e-3))))
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_us(fn, torch, rounds: int = 7, reps: int = 40) -> float:
    """Host microseconds of one call of fn (a wrapper's Python, ctypes
    and CUDA runtime calls): the median over rounds of reps calls, each
    round enqueued behind a sleep kernel, so no call waits for the card
    (the median, as the host's cores are shared and a round can stall)."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        torch.cuda._sleep(SLEEP_CYCLES)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t) * 1e6 / reps)
        torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


# the host's CUDA runtime calls that profile_op counts
RUNTIME_CALLS = ("cudaFuncSetAttribute", "cudaLaunchKernel")


def profile_op(torch, label: str, fn, card: str, wrappers,
               top: int = 6) -> None:
    """One call of fn under torch.profiler: wall time, summed device time
    of its kernels (device-side events only, so a torch op and the kernel
    it launches are not both counted), the device's idle share, the
    costliest kernels and every kernel of the port's own (bgn_*), each
    with its share of the busy time, each wrapper's launches in the call,
    and the count and host time of the runtime calls RUNTIME_CALLS (a
    kernel's launch, a launcher's shared-memory limit).  The raw
    events are read directly: key_averages() takes minutes over the ~10^6
    events of a limb-path call.  The profiler's own host overhead
    lengthens the wall time, so the idle share is an upper estimate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for wfn in wrappers.values():
        wfn.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    by_name, runtime = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        elif e.name() in RUNTIME_CALLS:
            us, n = runtime.get(e.name(), (0.0, 0))
            runtime[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    log(f"trace {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall:.3f}, "
        f"{sum(n for _, n in by_name.values())} device ops [{card}]")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in rows[:top] + [r for r in rows[top:]
                                       if "bgn_" in r[0]]:
        log(f"  {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f} %  x{n:<6d} "
            f"{name[:70]}")
    log("  launches: " + str({name: wfn.launches
                              for name, wfn in wrappers.items()
                              if wfn.launches}))
    log("  host runtime calls: " + ", ".join(
        f"{name} x{n} {us:.0f} us ({us / max(n, 1):.2f} us each)"
        for name, (us, n) in sorted(runtime.items())))
    return wall, busy, by_name


def ptxas_table(report: str) -> list:
    """Per kernel entry and template arguments (the slot count S, a limb
    cap, or mont_mul's words W and threads per lane G): registers, and the
    largest stack frame and spill sizes ptxas reports for the entry and
    its callees."""
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+bgn_(\w+?)_kernel"
                      r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", line)
        if m:
            cur = {"kernel": m.group(1), "S": int(m.group(2) or 0),
                   "G": int(m.group(3) or 0),
                   "registers": None, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            for key, v in zip(("stack", "spill_stores", "spill_loads"),
                              m.groups()):
                cur[key] = max(cur[key], int(v))
    return sorted(rows, key=lambda r: (r["kernel"], r["S"], r["G"]))


def sass_counts(obj: Path, nvcc: str, opcode: str) -> dict:
    """{S: number of `opcode` instructions} in the SASS of an object file
    (cuobjdump -sass, from nvcc's directory), per slot count S: summed
    over every function whose mangled name holds the template argument S
    (a kernel instantiation and the out-of-line device functions it
    calls, which cuobjdump lists as functions of their own)."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(obj)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"ILi(\d+)E", line)
            cur = int(m.group(1)) if m else None
            if cur is not None:
                counts.setdefault(cur, 0)
        elif cur is not None and re.search(rf"\b{opcode}\b", line):
            counts[cur] += 1
    return counts


def keygen_2048(path: str, seed: int, repo: str) -> None:
    """Child process of phases 1-2: phase 4e's 2048-bit key and decryption
    tables, built on the host (device="cpu": the number theory, its prime
    search in the native library, and the window tables in Python)
    while phase 1 builds the kernels, saved to
    path (with its own seconds) for phase 4e to load and move to the
    card."""
    t0 = time.time()
    sys.path.insert(0, repo)
    import torch
    from bgn_torch import scheme
    pk, sk = scheme.keygen(2048, 1021, rng=random.Random(seed), device="cpu")
    tables = pk.setup_decryption(sk, rng=random.Random(seed))
    torch.save((pk, sk, tables, time.time() - t0), path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--decrypt-batch", type=int, default=2048)
    ap.add_argument("--wide-batch", type=int, default=512)
    ap.add_argument("--big-batch", type=int, default=16)
    ap.add_argument("--limb-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run "
                 "needs the card")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import numpy as np

    from bgn_torch import _build, hostmath as hm, scheme
    from bgn_torch.config import BGNParams
    from bgn_torch.fieldcore import cuda_mont, limbs as lb, montgomery as mg
    from bgn_torch.fieldcore import rns as rn
    from bgn_torch.ops import cuda_pairing, cuda_rns, rns_pairing as rp
    from bgn_torch.utils import convert, rng as rng_mod

    # kernel name -> wrapper (its launch count)
    wrappers = {w.__name__: w for w in cuda_rns.WRAPPERS}
    wrappers.update(mont_mul=cuda_mont.mont_mul,
                    miller_dbl_digits=cuda_pairing.dbl_step,
                    miller_add_digits=cuda_pairing.add_step)
    step_wrappers = tuple(getattr(cuda_rns, name) for name in STEP_PATH)

    def in_step_mode(fn):
        """fn() under BGNParams(rns_pallas="1"), the default mode after."""
        BGNParams(rns_pallas="1").apply_kernel_modes()
        try:
            return fn()
        finally:
            BGNParams(rns_pallas="loop").apply_kernel_modes()

    def in_limb_mode(fn, fused=True):
        """fn() under BGNParams(rns_miller="0", fused_miller=fused), the
        default modes after."""
        BGNParams(rns_miller="0", fused_miller=fused).apply_kernel_modes()
        try:
            return fn()
        finally:
            BGNParams(rns_miller="auto", fused_miller=True) \
                .apply_kernel_modes()

    dev = torch.device("cuda")
    t_start = phase_t = time.time()

    def phase_done(name: str) -> None:
        nonlocal phase_t
        now = time.time()
        log(f"phase {name}: {now - phase_t:.1f} s (total "
            f"{now - t_start:.1f} s)")
        phase_t = now

    # phase 4e's 2048-bit key is built on the host by a child process
    # during phases 1-2 (daemon: it ends with this script)
    import multiprocessing
    key_path = repo / "build" / "smoke_key2048.pt"
    key_path.parent.mkdir(parents=True, exist_ok=True)
    t_key3 = time.time()
    key_proc = multiprocessing.get_context("spawn").Process(
        target=keygen_2048, args=(str(key_path), args.seed, str(repo)),
        daemon=True)
    key_proc.start()

    # -- 1. the card and the build ------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.time()
    _build.build(force=True)
    _build.library()
    log(f"build: {time.time() - t0:.1f} s (nvcc, {len(list(_build.CSRC.glob('*.cu')))} "
        "sources in parallel, each RNS kernel for S = 4, 6 and 12 slots, "
        "each digit kernel for L = 34 and 64 and its loop for any other "
        "L, mont_mul for the keys' word counts and its loop for any L)")
    ptxas = ptxas_table(_build.BUILD_INFO["ptxas"])
    for r in ptxas:
        words = f"W={r['S']} G={r['G']}"
        tag = {"mont_words": words, "mont_loop": "any L",
               "miller_dbl_digits": words, "miller_add_digits": words,
               "miller_dbl_digits_loop": "any other L",
               "miller_add_digits_loop": "any other L"}.get(
                   r["kernel"], f"S={r['S']}")
        log(f"  ptxas {r['kernel']:<22s} {tag}: {r['registers']} "
            f"registers, stack {r['stack']} B, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
    for k_ in (45, 90, 185):
        lay = cuda_rns.blob_layout(k_)
        S_ = cuda_rns.slots_for(k_)
        log(f"  k = {k_}: S = {S_}, {lay['smem'] * 4} B "
            f"of dynamic shared memory per block, {lay['words'] * 4} B of "
            f"constants; miller_loop: "
            f"{_build.library().bgn_miller_loop_smem(k_, S_)} B of dynamic "
            "shared memory per block")
    for k_ in (45, 90, 185):
        S_ = cuda_rns.slots_for(k_)
        log(f"  k = {k_}: {', '.join(TC_KERNELS[1:])} (blocks of G "
            "lanes, the rns_tc.cuh layout of miller_loop): "
            f"{_build.library().bgn_miller_loop_smem(k_, S_)} B of dynamic "
            "shared memory per block")
    imma = {}
    for name in TC_KERNELS:
        imma[name] = sass_counts(_build.BUILD_DIR / f"{name}.o",
                                 _build._nvcc(), "IMMA")
        log(f"  IMMA (tensor-core) instructions in the SASS of "
            f"bgn_{name}_kernel<S> and its callees: {imma[name]}")
        if any(imma[name].get(S_, 0) < 1 for S_ in cuda_rns.SLOTS):
            raise AssertionError(f"no IMMA in the SASS of {name}: "
                                 f"{imma[name]}")
    phase_done("1 (card, build)")

    # -- 2. keys --------------------------------------------------------
    t0 = time.time()
    rng = random.Random(args.seed)
    pk, sk = scheme.keygen(512, 1021, rng=rng, device="cuda")
    tables = pk.setup_decryption(sk, rng=rng)
    ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
    k, L = rns.k, ctx.L
    t_keys = {"512 (phase 2)": time.time() - t0}
    log(f"keys: 512-bit, msg space 1021, k = {k} channels per base, "
        f"L = {L} limbs, {t_keys['512 (phase 2)']:.1f} s (host keygen and "
        "tables, the native prime search)")
    t0 = time.time()
    key_proc.join()
    if key_proc.exitcode != 0:
        raise RuntimeError(f"the 2048-bit keygen process failed "
                           f"(exit {key_proc.exitcode})")
    log(f"keys: the 2048-bit keygen child, started before phase 1, done "
        f"{time.time() - t_key3:.1f} s after its start "
        f"({time.time() - t0:.1f} s waited here)")
    phase_done("2 (keys)")

    # -- 3. kernels against their plain versions -------------------------
    B, Bd = args.batch, args.decrypt_batch
    results = {}
    f32 = 4

    def check(name, shape, kern, plain, elem_mm, nbytes, key_bits,
              products=None):
        """The kernel against its plain version (one call of the plain
        version, which is also its time), then the kernel's time.
        products: the chain's products, for the time per product of a lone
        lane."""
        got = kern()
        torch.cuda.synchronize()
        t = time.time()
        want = plain()
        torch.cuda.synchronize()
        ms_p = (time.time() - t) * 1e3
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        if not equal:
            raise AssertionError(f"{name} {shape} ({key_bits}-bit): kernel "
                                 f"!= plain (max abs err {err})")
        ms_k = cuda_ms(kern, torch)
        b_ms, b_by = bound(elem_mm[0], elem_mm[1], nbytes, *elem_mm[2:])
        rec = {"shape": shape, "key_bits": key_bits, "ms": ms_k,
               "plain_ms": ms_p, "max_abs_err": err, "bound_ms": b_ms,
               "bound_by": b_by}
        note = ""
        if products:
            rec["us_per_product"] = ms_k * 1e3 / products
            note = (f"; {rec['us_per_product']:.2f} us per product over "
                    f"{products} dependent products")
        log(f"kernel {name} {shape} ({key_bits}-bit): equal to plain; "
            f"{ms_k:.3f} ms (plain {ms_p:.1f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}){note} [{card}]")
        results.setdefault(name, []).append(rec)
        return got

    def chain_equal(name, shape, want, fn, key_bits):
        """A chain of step-kernel launches (the per-step configuration's
        host loop) against the loop kernel's output, bit for bit."""
        before = sum(w.launches for w in step_wrappers)
        got = fn()
        n = sum(w.launches for w in step_wrappers) - before
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if n < 1 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{n} step launches != {name} {shape} "
                                 f"({key_bits}-bit)")
        log(f"chain of {n} step launches equals {name} {shape} "
            f"({key_bits}-bit)")

    def dual_ladder_checks(pk, dig_np, m_neg, Jm, lanes, ident_lane):
        """dual_ladder against its plain version at each N of lanes over
        the digits dig_np [Jm + Jr, N] and m_neg (the identity lane's Z
        must be 0); the output at lanes[0].  The bound counts the live
        windows' additions, the combines of lanes with both chains live
        and the live windows' rows."""
        rns, dk, key_bits = pk.dev.rns, pk.dev, pk.key_bits
        k, state = rns.k, 2 * rns.k * f32
        dig = torch.as_tensor(dig_np, device=dev)
        mneg = torch.as_tensor(m_neg, device=dev)
        e1, m1 = ops_of(k, {"add_pt": 1})
        e2, m2 = ops_of(k, {"jac_add_full": 1})
        Jt = dig_np.shape[0]
        first = None
        for n in dict.fromkeys(lanes):
            live = dig_np[:, :n] != 0
            adds = 0
            for rows in (live[:Jm], live[Jm:]):
                adds += int(np.maximum(rows.sum(axis=0) - 1, 0).sum())
            combines = int((live[:Jm].any(axis=0)
                            & live[Jm:].any(axis=0)).sum())
            d_n, mn_n = dig[:, :n].contiguous(), mneg[:n].contiguous()
            out = check(
                "dual_ladder", f"B={n}, Jm={Jm}, Jt={Jt}",
                lambda d=d_n, mn=mn_n: cuda_rns.dual_ladder(
                    rns, dk.p_win, dk.q_win, Jm, d, mn),
                lambda d=d_n, mn=mn_n: cuda_rns.dual_ladder_plain(
                    rns, dk.p_win, dk.q_win, Jm, d, mn),
                (adds * e1 + combines * e2, adds * m1 + combines * m2),
                int(live.sum()) * 2 * state + (Jt + 1) * n * 4
                + 3 * n * state, key_bits)
            if n > ident_lane and bool((out[2][:, ident_lane] != 0).any()):
                raise AssertionError(f"dual_ladder B={n}: the identity "
                                     "lane's Z is not 0")
            first = out if first is None else first
        return first

    def exit_check(pk, n, seed):
        """rns_exit, both halves in one launch, against rns_exit_plain at
        n lanes: to_rns_mont's outputs (bound 3; first lanes 0, 1 and
        p - 1), whose limbs the first half must give back, and their
        doubles (bound 6); then its time against its bound."""
        ctx, rns = pk.dev.ctx, pk.dev.rns
        k, L = rns.k, ctx.L
        erng = random.Random(seed)
        vals = [0, 1, pk.p - 1] + [erng.randrange(pk.p) for _ in range(n)]
        limbs = torch.as_tensor(lb.ints_to_limbs(vals[:n], L), device=dev)
        x0 = rn.to_rns_mont(rns, limbs)
        xs = (x0.v.contiguous(), rn.r_add(rns, x0, x0).v.contiguous())
        e, mm = ops_of(k, {"r_mul": 1})
        d8 = cuda_rns.exit_layout(k, L)["d8"]
        out = check("rns_exit", f"N={n}, 2 halves",
                    lambda: cuda_rns.rns_exit(rns, *xs),
                    lambda: cuda_rns.rns_exit_plain(rns, *xs),
                    (2 * n * e, 2 * n * mm, 2 * n * k * d8),
                    2 * n * (2 * k * f32 + L * 8), pk.key_bits)
        torch.cuda.synchronize()
        if not torch.equal(out[0][0], limbs):
            raise AssertionError(f"rns_exit N={n} ({pk.key_bits}-bit): "
                                 "to_rns_mont's limbs not given back")

    def kernel_checks(pk, sk, B, Bd, seed, trunc=None):
        """Each kernel at the shapes the paths give it for this key:
        dual_ladder, window_ladder_tab (also at B - 1 and 1; also on
        all-zero digits and Q's table) and window_ladder (at B, B - 1 and
        1 on four gathered streams, at B on a fifth), miller_loop at B
        lanes, ladder_loop and fp2_pow_loop (q1) at Bd, pow_loop at B and
        1; the step kernels at B (dbl_step, add_step,
        pt_dbl and pt_add also at B - 1, Bd and 1, pow_step and
        fp2_pow_step at B - 1, Bd, 7 and 1; pt_add also from a window
        chain's start, fp2_pow_step from an F_p^2 chain's start and with
        the conjugate operand, pt_dbl and pt_add at Bd on identity-base
        lanes), and a chain of step launches against each loop kernel.
        trunc: cut every digit string to its first trunc digits and the
        random exponents to trunc bits (the plain versions then stay
        short)."""
        ctx, rns, dk = pk.dev.ctx, pk.dev.rns, pk.dev
        k, key_bits = rns.k, pk.key_bits
        state = 2 * k * f32                # bytes of one residue element
        krng = random.Random(seed)
        top = pk.n if trunc is None else 1 << trunc
        # fixed lanes before the random ones: m = 0 with r != 0, r = 0
        # with m != 0, m < 0 (m_neg = 1) with r != 0 and with r = 0, and
        # the identity m = r = 0 (lane IDENT)
        ms = [0, 100, -13, -7, 0] + [krng.randrange(340)
                                     for _ in range(B - 5)]
        rs = [12345, 0, 424242, 0, 0] + [krng.randrange(top)
                                         for _ in range(B - 5)]
        ident_lane = 4
        m_digits, m_neg = scheme._signed_digits(ms, pk.n)
        r_digits, _ = scheme._signed_digits(rs, pk.n)
        Jm = m_digits.shape[0]
        dig_np = np.concatenate([m_digits, r_digits], axis=0)
        n_naf = dk.n_naf.cpu().numpy()[:trunc]
        pm2 = ctx.pm2_bits.cpu().numpy()[:trunc]
        l_bits = dk.l_bits.cpu().numpy()[:trunc]
        q1_naf = np.asarray(sk.q1_naf)[:trunc]

        # dual ladder (Encrypt core) at B lanes, and at B - 1, Bd (the
        # decryption-proof check) and 1 (a ragged and a short last block)
        X, Y, Z = dual_ladder_checks(pk, dig_np, m_neg, Jm,
                                     (B, B - 1, Bd, 1), ident_lane)
        e1, m1 = ops_of(k, {"add_pt": 1})

        # window_ladder_tab (EncryptDeterministic; E_det(0) behind
        # encrypt_zero and Neg) on P's table at B, B - 1 and 1 lanes over
        # the bench digits (m < 340) and full-width digits (m < n), the
        # first lanes fixed: m = 0, the identity, m = 256 (only window 1
        # live) and m = 255 (only window 0 live); at B also on all-zero
        # digits [2, B] (E_det(0)) and on Q's table over r < n digits.  Z
        # is 0 exactly on the lanes with no live window.  The bounds
        # count the live windows' additions and rows.  Then the step-mode
        # chain on the full-width digits at B, and window_ladder.
        wide = "m<n" if trunc is None else f"m<2^{trunc}"
        fixed = [0, 256, 255]

        def digits_of(values):
            return scheme._signed_digits(values, pk.n)[0]

        tab_outs = {}                 # (label, n) -> (digits, output)
        wcases = (
            ("m<340", dk.p_win, digits_of(
                fixed + [krng.randrange(340) for _ in range(B - 3)]),
             (B, B - 1, 1)),
            (wide, dk.p_win, digits_of(
                fixed + [krng.randrange(top) for _ in range(B - 3)]),
             (B, B - 1, Bd, 8, 1)),
            ("all zero, E_det(0)", dk.p_win, digits_of([0] * B), (B,)),
            (wide.replace("m", "r") + ", Q's table", dk.q_win, digits_of(
                [krng.randrange(top) for _ in range(B)]), (B,)))
        for label, tab, dnp, lanes in wcases:
            for n in dict.fromkeys(lanes):
                d_n = np.ascontiguousarray(dnp[:, :n])
                lv = d_n != 0
                n_add = int(np.maximum(lv.sum(axis=0) - 1, 0).sum())
                row_bytes = int(lv.sum()) * 2 * state
                dgt = torch.as_tensor(d_n, device=dev)
                out = check(
                    "window_ladder_tab", f"B={n}, Jd={d_n.shape[0]} "
                    f"({label})",
                    lambda t=tab, d=dgt: cuda_rns.window_ladder_tab(rns, t,
                                                                    d),
                    lambda t=tab, d=dgt: cuda_rns.window_ladder_tab_plain(
                        rns, t, d),
                    (n_add * e1, n_add * m1),
                    row_bytes + d_n.size * 4 + 3 * n * state, key_bits)
                zero = torch.all(out[2] == 0, dim=0).cpu().numpy()
                if not np.array_equal(zero, ~lv.any(axis=0)):
                    raise AssertionError(
                        f"window_ladder_tab B={n} ({label}): Z is not 0 "
                        "exactly on the lanes with no live window")
                tab_outs[(label, n)] = (d_n, out)
        dnp, tab_out = tab_outs[(wide, B)]
        chain_equal("window_ladder_tab", f"B={B}, Jd={dnp.shape[0]} "
                    f"({wide})", tab_out,
                    lambda: tuple(v.v for v in in_step_mode(
                        lambda: rp.fixed_base_mul_rns(
                            ctx, rns, dk.p_win,
                            torch.as_tensor(dnp, device=dev), raw=True))),
                    key_bits)

        # window_ladder (on no path: the same chain over a gathered
        # stream) at B, B - 1 and 1 lanes on streams gathered from P's
        # table: the full-width and the m < 340 digits above, equal to
        # window_ladder_tab on the same rows too (at N = 1 the lane m = 0,
        # every window dead); and two streams whose dead rows hold a
        # point (the full-width digits, each 0 gathered as row 1): every
        # window dead (every output 0), and whole blocks of TC_G lanes
        # dead at a third of the windows while the other blocks are live
        # there (the windows the kernel's blocks skip; at N = 1 a lone
        # lane live at two thirds of them); at B also E_det(0)'s rows, all
        # dead (window_ladder_tab's all-zero digits, equal to it too).  Z
        # is 0 exactly on the lanes with no live window.  The bounds count
        # the live windows' additions and rows.
        m340 = tab_outs[("m<340", B)][0]
        zero_d = tab_outs[("all zero, E_det(0)", B)][0]
        block_dead = (np.arange(B)[None] // TC_G * 7
                      + np.arange(dnp.shape[0])[:, None]) % 3 == 0
        every = (B, B - 1, 1)
        gcases = ((f"{wide}, gathered", dnp, dnp == 0, wide, every),
                  ("m<340, gathered", m340, m340 == 0, "m<340", every),
                  ("every window dead, rows nonzero",
                   np.where(dnp == 0, 1, dnp), np.ones(dnp.shape, bool),
                   None, every),
                  (f"blocks of {TC_G} dead at a third of the windows, "
                   "rows nonzero", np.where(dnp == 0, 1, dnp), block_dead,
                   None, every),
                  ("all zero, E_det(0), gathered", zero_d, zero_d == 0,
                   "all zero, E_det(0)", (B,)))
        for label, rows_of, dead, tab_label, lanes in gcases:
            gx, gy = cuda_rns._gather_rows(dk.p_win, torch.as_tensor(
                rows_of, device=dev))
            for n in dict.fromkeys(lanes):
                lv = ~dead[:, :n]
                n_add = int(np.maximum(lv.sum(axis=0) - 1, 0).sum())
                gx_n, gy_n = (g[:, :, :n].contiguous() for g in (gx, gy))
                ginf = torch.as_tensor(dead[:, :n], device=dev)
                out = check(
                    "window_ladder", f"B={n}, Jd={dead.shape[0]} ({label})",
                    lambda x=gx_n, y=gy_n, f=ginf: cuda_rns.window_ladder(
                        rns, x, y, f),
                    lambda x=gx_n, y=gy_n, f=ginf:
                        cuda_rns.window_ladder_plain(rns, x, y, f),
                    (n_add * e1, n_add * m1),
                    int(lv.sum()) * 2 * state + lv.size * 4
                    + 3 * n * state, key_bits)
                zero = torch.all(out[2] == 0, dim=0).cpu().numpy()
                if not np.array_equal(zero, ~lv.any(axis=0)):
                    raise AssertionError(
                        f"window_ladder B={n} ({label}): Z is not 0 "
                        "exactly on the lanes with no live window")
                if not lv.any() and any(bool(v.any()) for v in out):
                    raise AssertionError(f"window_ladder B={n} ({label}): "
                                         "an output lane is not 0")
                if tab_label is not None and not all(
                        torch.equal(u, v) for u, v in
                        zip(out, tab_outs[(tab_label, n)][1])):
                    raise AssertionError(f"window_ladder B={n} ({label}) "
                                         "!= window_ladder_tab")
                del gx_n, gy_n
            del gx, gy

        # ciphertext points -> Miller inputs (normalize runs pow_loop, N=1)
        pt = rp.normalize_rns(ctx, rns, X, Y, Z)
        ax = rn.to_rns_mont(rns, pt.x).v
        ay = rn.to_rns_mont(rns, pt.y).v
        xb, yb = ax.roll(1, dims=1).contiguous(), ay.roll(1, dims=1).contiguous()
        nz = np.nonzero(n_naf)[0]
        start = int(nz[0]) if nz.size else 0
        nd = len(n_naf)
        n_dbl = nd - start - 1
        n_add = int(np.count_nonzero(n_naf[start + 1:nd - 1]))
        e, mm = ops_of(k, {"dbl_step": n_dbl, "add_step": n_add})
        fr, fi = check(
            "miller_loop", f"B={B}, digits={nd}",
            lambda: cuda_rns.miller_loop(rns, ax, ay, xb, yb, n_naf),
            lambda: cuda_rns.miller_loop_plain(rns, ax, ay, xb, yb, n_naf),
            (B * e, B * mm), 4 * B * state + nd * 4 + 2 * B * state,
            key_bits)
        chain_equal("miller_loop", f"B={B}, digits={nd}", (fr, fi),
                    lambda: cuda_rns._miller_chain(
                        rns, ax, ay, xb, yb, n_naf, cuda_rns.dbl_step,
                        cuda_rns.add_step), key_bits)
        if key_bits == 512:           # a ragged last block of G lanes
            for n in (B - 3, 1):
                args_n = tuple(v[:, :n].contiguous()
                               for v in (ax, ay, xb, yb))
                got = cuda_rns.miller_loop(rns, *args_n, n_naf)
                want = cuda_rns.miller_loop_plain(rns, *args_n, n_naf)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"miller_loop N={n} != plain")
                log(f"kernel miller_loop N={n} ({key_bits}-bit): equal to "
                    "plain")

        # ladder_loop (L1 decrypt: csk = C^q1) at Bd lanes, a few of them
        # identity-base lanes (x = y = 0 limbs: zero residues), as
        # scalar_mul_rns passes them
        cx, cy = ax[:, :Bd].clone(), ay[:, :Bd].clone()
        ident = sorted({0, Bd // 3, Bd - 1})
        cx[:, ident] = 0
        cy[:, ident] = 0
        one = rns.one_rns.expand_as(cx).contiguous()
        qd = np.asarray(sk.q1_naf)[1:][:trunc]
        e, mm = ops_of(k, {"dbl_pt": len(qd),
                           "add_pt": int(np.count_nonzero(qd))})
        lad = check("ladder_loop", f"N={Bd}, q1_naf={len(qd)}, identity "
                    f"lanes {ident}",
                    lambda: cuda_rns.ladder_loop(rns, cx, cy, one, cx, cy,
                                                 qd),
                    lambda: cuda_rns.ladder_loop_plain(rns, cx, cy, one, cx,
                                                       cy, qd),
                    (Bd * e, Bd * mm), 5 * Bd * state + len(qd) * 4
                    + 3 * Bd * state, key_bits)
        chain_equal("ladder_loop", f"N={Bd}, q1_naf={len(qd)}", lad,
                    lambda: cuda_rns._ladder_chain(
                        rns, cx, cy, one, cx, cy, qd, cuda_rns.pt_dbl,
                        cuda_rns.pt_add), key_bits)
        if key_bits == 512:           # a short last block of G lanes
            n = Bd - 3
            args_n = tuple(v[:, :n].contiguous() for v in (cx, cy, one))
            got = cuda_rns.ladder_loop(rns, *args_n, *args_n[:2], qd)
            want = cuda_rns.ladder_loop_plain(rns, *args_n, *args_n[:2], qd)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"ladder_loop N={n} != plain")
            log(f"kernel ladder_loop N={n}, identity lanes "
                f"{[i for i in ident if i < n]} ({key_bits}-bit): equal to "
                "plain")

        # pow_loop: the norm inversion of _fp2_inv (N = B), normalize and
        # mont_inv_rns (N = 1); at 512 bits also short last blocks (B - 3,
        # 7, 2) and a small batch
        aa, bb = rn.r_mul_many(rns, [(rn.RVal(fr, 9), rn.RVal(fr, 9)),
                                     (rn.RVal(fi, 9), rn.RVal(fi, 9))])
        norm = rn.r_add(rns, aa, bb).v.contiguous()
        n_prod = len(pm2) + int(np.count_nonzero(pm2))
        e, mm = ops_of(k, {"r_mul": n_prod})
        for n in ((B, B - 3, 64, 7, 2, 1) if key_bits == 512 else (B, 1)):
            x = norm[:, :n].contiguous()
            pw = check("pow_loop", f"N={n}, bits={len(pm2)}",
                       lambda x=x: cuda_rns.pow_loop(rns, x, pm2),
                       lambda x=x: cuda_rns.pow_loop_plain(rns, x, pm2),
                       (n * e, n * mm), 2 * n * state + len(pm2) * 4,
                       key_bits, products=n_prod if n == 1 else None)
            if n in (B, 1):
                chain_equal("pow_loop", f"N={n}, bits={len(pm2)}", pw,
                            lambda x=x: cuda_rns._pow_chain(
                                rns, x, pm2, cuda_rns.pow_step), key_bits)

        # fp2_pow_loop: ^l (final exponentiation, B), z^q1 (decrypt, Bd)
        f = (rn.RVal(fr, 9), rn.RVal(fi, 9))
        inv = rp._fp2_inv(rns, f, ctx.pm2_bits)
        w = rp._fp2_mul(rns, rp._fp2_conj(rns, f), inv)
        wr, wi = w[0].v.contiguous(), w[1].v.contiguous()
        z = None
        for name_d, digs, n in (("l_bits", l_bits, B), ("q1_naf", q1_naf, Bd)):
            xr = (wr if z is None else z[0])[:, :n].contiguous()
            xi = (wi if z is None else z[1])[:, :n].contiguous()
            nzd = int(np.count_nonzero(digs))
            e, mm = ops_of(k, {"fp2_sqr": len(digs), "fp2_mul": nzd})
            z = check("fp2_pow_loop", f"N={n}, {name_d}={len(digs)}",
                      lambda xr=xr, xi=xi, d=digs: cuda_rns.fp2_pow_loop(
                          rns, xr, xi, d),
                      lambda xr=xr, xi=xi, d=digs:
                          cuda_rns.fp2_pow_loop_plain(rns, xr, xi, d),
                      (n * e, n * mm), 4 * n * state + len(digs) * 4,
                      key_bits)
            chain_equal("fp2_pow_loop", f"N={n}, {name_d}={len(digs)}", z,
                        lambda xr=xr, xi=xi, d=digs: cuda_rns._fp2_chain(
                            rns, xr, xi, d, cuda_rns.fp2_pow_step),
                        key_bits)

        # the six step kernels, one launch each, at the shapes of the
        # per-step configuration: Miller steps at B (state: the dual
        # ladder's point, lane IDENT the identity, and the Miller value;
        # also at Bd, as MakeL2 runs them), the G1 steps on the same point
        # at B (the window chains) and Bd (the decrypt ladder), pow_step
        # at B, Bd and 1, fp2_pow_step at B and Bd, both with bit 1 and 0;
        # dbl_step, add_step, pt_dbl, pt_add, pow_step and fp2_pow_step
        # also at ragged and short blocks of G lanes
        blob = cuda_rns.blob_layout(k)["words"] * f32
        st = tuple(v.contiguous() for v in (X, Y, Z, fr, fi))

        def step_check(name, ins, counts, rows, n, label=""):
            e, mm = ops_of(k, counts)
            check(name, f"N={n}{label}",
                  lambda f=getattr(cuda_rns, name), a=ins: f(rns, *a),
                  lambda f=getattr(cuda_rns, name + "_plain"), a=ins:
                      f(rns, *a),
                  (n * e, n * mm), rows * n * state + blob, key_bits)

        for name, ins, counts, rows in (
                ("dbl_step", st + (xb, yb), {"dbl_step": 1}, 12),
                ("add_step", st + (ax, ay, xb, yb), {"add_step": 1}, 14),
                ("pt_dbl", st[:3], {"dbl_pt": 1}, 6),
                ("pt_add", st[:3] + (ax, ay), {"add_pt": 1}, 8)):
            for n in dict.fromkeys((B, B - 1, Bd, 1)):
                step_check(name, tuple(v[:, :n].contiguous() for v in ins),
                           counts, rows, n)
        # the G1 steps at each path's own input kind: a window chain's
        # first addition (_window_chain: X = Y = 0, Z = one, and window
        # 0's gathered rows, row 0 where the digit is 0) and the decrypt
        # ladder's first doubling and addition from ladder_loop's input
        # (its identity-base lanes on zero residues)
        wx, wy = (g[0].contiguous() for g in cuda_rns._gather_rows(
            dk.p_win, dgt[:1]))
        one_b = rns.one_rns.expand_as(wx).contiguous()
        zero_b = torch.zeros_like(one_b)
        step_check("pt_add", (zero_b, zero_b, one_b, wx, wy),
                   {"add_pt": 1}, 8, B, ", window-chain start")
        del wx, wy, one_b, zero_b
        step_check("pt_dbl", (cx, cy, one), {"dbl_pt": 1}, 6, Bd,
                   f", identity-base lanes {ident}")
        step_check("pt_add", tuple(v.contiguous() for v in
                                   cuda_rns.pt_dbl_plain(rns, cx, cy, one))
                   + (cx, cy), {"add_pt": 1}, 8, Bd,
                   f", identity-base lanes {ident}")
        for n in dict.fromkeys((B, B - 1, Bd, 7, 1)):
            for bit in (1, 0):
                ins = (aa.v[:, :n].contiguous(), norm[:, :n].contiguous(),
                       bit)
                e, mm = ops_of(k, {"r_mul": 1 + bit})
                check("pow_step", f"N={n}, bit={bit}",
                      lambda a=ins: cuda_rns.pow_step(rns, *a),
                      lambda a=ins: cuda_rns.pow_step_plain(rns, *a),
                      (n * e, n * mm), (2 + bit) * n * state + blob,
                      key_bits)
        # fp2_pow_step on the Miller value and the unitary w of the
        # final exponentiation, with bit 1 and 0, at B (^l), B - 1, Bd
        # (z^q1), 7 and 1; with bit 1 also from a chain's start (ar = one,
        # ai = 0, the first digit of both chains) at B and Bd, and with
        # the conjugate operand (xi = 10p - wi, _fp2_chain's on a -1
        # digit) at Bd
        one_w = rns.one_rns.expand_as(wr).contiguous()
        fp2_cases = [(n, bit, "", (fr, fi, wr, wi))
                     for n in dict.fromkeys((B, B - 1, Bd, 7, 1))
                     for bit in (1, 0)]
        fp2_cases += [(n, 1, ", chain start", (one_w, torch.zeros_like(wr),
                                               wr, wi))
                      for n in dict.fromkeys((B, Bd))]
        fp2_cases.append((Bd, 1, ", conj(x)", (fr, fi, wr,
                                               cuda_rns._conj_im(rns, wi))))
        for n, bit, label, vals in fp2_cases:
            ins = tuple(v[:, :n].contiguous() for v in vals) + (bit,)
            e, mm = ops_of(k, {"fp2_sqr": 1, "fp2_mul": bit})
            check("fp2_pow_step", f"N={n}, bit={bit}{label}",
                  lambda a=ins: cuda_rns.fp2_pow_step(rns, *a),
                  lambda a=ins: cuda_rns.fp2_pow_step_plain(rns, *a),
                  (n * e, n * mm), (4 + 2 * bit) * n * state + blob,
                  key_bits)

    kernel_checks(pk, sk, B, Bd, args.seed + 1)
    exit_check(pk, B, args.seed + 10)

    # dual_ladder at the proof-of-knowledge prover's shape (phase 4j): one
    # batch of Bd lanes of m < 340 with r < n, then Bd nonces m < n with
    # r = 0 (Jm = Jr), at N = 2 Bd, 2 Bd - 1 and 1; the fixed first lanes
    # of kernel_checks, the identity at lane 4
    prng = random.Random(args.seed + 12)
    p_ms = [0, 100, -13, -7, 0] + [prng.randrange(340)
                                   for _ in range(Bd - 5)] \
        + [prng.randrange(pk.n) for _ in range(Bd)]
    p_rs = [12345, 0, 424242, 0, 0] + [prng.randrange(pk.n)
                                       for _ in range(Bd - 5)] + [0] * Bd
    pm_dig, pm_neg = scheme._signed_digits(p_ms, pk.n)
    pr_dig, _ = scheme._signed_digits(p_rs, pk.n)
    dual_ladder_checks(pk, np.concatenate([pm_dig, pr_dig]), pm_neg,
                       pm_dig.shape[0], (2 * Bd, 2 * Bd - 1, 1), 4)
    del pm_dig, pr_dig

    # the synthesized 64-bit key of phase 4j's conformance check (a few
    # channels per base, most of a block's slots empty): dual_ladder at
    # N = 8 (the bucket the seven vectors encrypt in), 7 and 1 over the
    # vectors' (m, r), and pow_loop (normalize's inversion) at N = 7 and 1
    from bgn_torch.interop import conformance as iconf, reference as iref
    vec64 = iconf.synthesize_vectors(64, 101)
    pk64, _ = iref.import_reference_key(vec64, device="cuda")
    rns64, ctx64 = pk64.dev.rns, pk64.dev.ctx
    v_ms = [int(cv["m"]) for cv in vec64["ciphertexts"]] + [0]
    v_rs = [int(cv["r"], 16) for cv in vec64["ciphertexts"]] + [0]
    m64, mneg64 = scheme._signed_digits(v_ms, pk64.n)
    r64, _ = scheme._signed_digits(v_rs, pk64.n)
    X64, _, Z64 = dual_ladder_checks(pk64, np.concatenate([m64, r64]),
                                     mneg64, m64.shape[0], (8, 7, 1), 7)
    xz64 = rn.r_mul(rns64, rn.RVal(X64, 27), rn.RVal(Z64, 6)).v
    pm2_64 = ctx64.pm2_bits.cpu().numpy()
    e64, mm64 = ops_of(rns64.k, {"r_mul": len(pm2_64)
                                 + int(np.count_nonzero(pm2_64))})
    for n64 in (7, 1):
        check("pow_loop", f"N={n64}, bits={len(pm2_64)}",
              lambda x=xz64[:, :n64].contiguous(): cuda_rns.pow_loop(
                  rns64, x, pm2_64),
              lambda x=xz64[:, :n64].contiguous(): cuda_rns.pow_loop_plain(
                  rns64, x, pm2_64),
              (n64 * e64, n64 * mm64),
              2 * n64 * 2 * rns64.k * f32 + len(pm2_64) * 4, pk64.key_bits)
    log(f"kernels at the synthesized 64-bit key (k = {rns64.k}, S = "
        f"{cuda_rns.slots_for(rns64.k)}, L = {ctx64.L}): dual_ladder and "
        "pow_loop equal to plain")

    def mont_checks(seed):
        """mont_mul against its plain version: L = 34 (the 512-bit key's
        limbs) at B lanes, also with a broadcast R^2 operand (to_mont's
        stride-0 lanes), at 1 and B - 1 lanes; L = 66, 130 and 258 (1024-,
        2048- and 4096-bit keys; 258 is the widest) and the odd L = 35 at
        512 lanes over random odd moduli of 16 L bits.  At the keys' widths the
        local-memory loop (bgn_mont_mul_loop, which bgn_mont_mul runs at
        every other L) is checked and timed beside the register kernel."""
        mrng = random.Random(seed)

        def loop_kernel(c, x, y):
            out = torch.empty_like(x)
            _build.launch("bgn_mont_mul_loop", _build.ptr(x), x.stride(0),
                          x.stride(1), _build.ptr(y), y.stride(0),
                          y.stride(1), _build.ptr(c.p), c.L,
                          _build.ptr(out), x.shape[1])
            return out

        for bits, Lm, n in ((512, L, B), (1024, 66, 512), (2048, 130, 512),
                            (4096, 258, 512), (528, 35, 512)):
            if bits == 512:
                mctx = ctx
            else:
                pm = mrng.getrandbits(16 * Lm) | (1 << (16 * Lm - 1)) | 1
                mctx = mg.make_mont_ctx(pm, L=Lm, device=dev)
            x, y = (torch.as_tensor(lb.ints_to_limbs(
                [mrng.randrange(mctx.p_host) for _ in range(n)], Lm),
                device=dev) for _ in range(2))
            cases = [("", y)]
            if bits == 512:
                cases.append((", R^2 broadcast", mctx.r2[:, None].expand(Lm, n)))
            for label, yy in cases:
                nbytes = 8 * Lm * (2 * n + (n if yy.stride(1) else 1))
                check("mont_mul", f"L={Lm}, N={n}{label}",
                      lambda c=mctx, y_=yy: cuda_mont.mont_mul(c, x, y_),
                      lambda c=mctx, y_=yy: cuda_mont.mont_mul_plain(c, x, y_),
                      (0, 0, mont_mads(Lm) * n), nbytes, bits)
            if Lm % 2 == 0:
                want = cuda_mont.mont_mul_plain(mctx, x, y)
                if not torch.equal(loop_kernel(mctx, x, y), want):
                    raise AssertionError(f"mont_mul loop L={Lm} != plain")
                t = cuda_ms(lambda c=mctx: loop_kernel(c, x, y), torch)
                results["mont_mul"][-len(cases)]["loop_ms"] = t
                log(f"  mont_mul L={Lm}, N={n} on the local-memory loop: "
                    f"equal to plain; {t:.4f} ms [{card}]")
            if bits == 512:           # ragged lane counts
                for m in (1, n - 1):
                    got = cuda_mont.mont_mul(mctx, x[:, :m], y[:, :m])
                    want = cuda_mont.mont_mul_plain(mctx, x[:, :m], y[:, :m])
                    if not torch.equal(got, want):
                        raise AssertionError(f"mont_mul L={Lm}, N={m} != "
                                             "plain")
                    log(f"kernel mont_mul L={Lm}, N={m}: equal to plain")

    mont_checks(args.seed + 8)

    def digit_checks(seed):
        """The two digit-domain Miller steps against their plain versions:
        at L = 34 on the 512-bit key's Miller state (ciphertexts as A and
        as B, V one doubling in) at B, B - 1 and 1 lanes; at L = 64 over
        random canonical digits modulo a 1000-bit prime at 512 lanes (the
        register form); at L = 35 and L = 6 over random digits modulo a
        540-bit and a 64-bit prime at 512 lanes (the loop form)."""
        drng = random.Random(seed)
        D = cuda_pairing.to_digits
        pts = pk.encrypt_with_randomness(
            [drng.randrange(340) for _ in range(B)],
            [drng.randrange(pk.n) for _ in range(B)]).data
        one = D(ctx.one[:, None].expand(L, B))
        A = (D(pts.x), D(pts.y))
        Bq = (D(pts.x.roll(1, dims=1)), D(pts.y.roll(1, dims=1)))
        V, f = cuda_pairing.dbl_step(ctx, (*A, one),
                                     (one, torch.zeros_like(one)), Bq)
        cases = [(ctx, V, f, A, Bq, 512)]
        for m in (B - 1, 1):          # ragged lane counts
            cut = lambda xs, m=m: tuple(x[:, :m].contiguous() for x in xs)
            cases.append((ctx, cut(V), cut(f), cut(A), cut(Bq), 512))
        for bits, Lm in ((1000, 64), (540, 35), (64, 6)):
            pm = hm.gen_prime(bits, rng=drng)
            mctx = mg.make_mont_ctx(pm, L=Lm, device=dev)

            def rnd(n=512):
                return D(torch.as_tensor(lb.ints_to_limbs(
                    [drng.randrange(pm) for _ in range(n)], Lm), device=dev))

            cases.append((mctx, (rnd(), rnd(), rnd()), (rnd(), rnd()),
                          (rnd(), rnd()), (rnd(), rnd()), bits))
        for c, V, f, A, Bq, bits in cases:
            Lc, n = c.L, V[0].shape[1]
            for name, fn, plain, fargs, products, arrays in (
                    ("miller_dbl_digits", cuda_pairing.dbl_step,
                     cuda_pairing.dbl_step_plain, (V, f, Bq), 21, 12),
                    ("miller_add_digits", cuda_pairing.add_step,
                     cuda_pairing.add_step_plain, (V, f, A, Bq), 17, 14)):
                check(name, f"L={Lc}, N={n}",
                      lambda fn=fn, c=c, a=fargs: sum(fn(c, *a), ()),
                      lambda fn=plain, c=c, a=fargs: sum(fn(c, *a), ()),
                      (0, 0, products * mont_mads(Lc) * n),
                      arrays * 2 * Lc * f32 * n, bits)

    digit_checks(args.seed + 9)
    phase_done("3 (kernels, 512-bit; mont_mul at 512, 1024, 2048 bits; "
               "digit steps at L = 34, 64, 35 and 6)")

    # -- 4. the main path end to end ---------------------------------------
    splits_of = {}             # path -> kernel -> split -> {key: launches}

    def zero_counts():
        for wfn in wrappers.values():
            wfn.launches = 0
            for split in SPLITS:
                getattr(wfn, split, {}).clear()

    def read_counts(path_name, must):
        counts = {name: wfn.launches for name, wfn in wrappers.items()}
        for name in must:
            if counts[name] < 1:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path_name} path")
        log(f"{path_name} launches: {counts}")
        splits_of[path_name] = {
            name: {split: dict(sorted(getattr(wfn, split).items()))
                   for split in SPLITS if getattr(wfn, split, None)}
            for name, wfn in wrappers.items()}
        for name, by in splits_of[path_name].items():
            for split, counts_by in by.items():
                log(f"{path_name}: {name} {split.replace('_', ' ')} "
                    f"{counts_by}")
        return counts

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    def decrypt_all(sk, pk, tables, ct, want, label, Bd, out=None):
        """Decrypt every lane, Bd at a time, and check it; returns the
        seconds of the first chunk.  out: a list the decrypted values are
        appended to."""
        got, t_first = [] if out is None else out, None
        for s in range(0, len(want), Bd):
            vals, t = timed(lambda s=s: sk.decrypt(ct[s:s + Bd], pk, tables))
            t_first = t if t_first is None else t_first
            got.extend(int(v) for v in vals)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} lanes decrypt wrong, "
                                 f"first {bad[:5]}")
        log(f"{label}: all {len(want)} lanes decrypt correctly")
        return t_first

    zero_counts()
    mrng = random.Random(args.seed + 2)
    ms = [mrng.randrange(340) for _ in range(B)]
    ks = [mrng.randrange(1, 4) for _ in range(B)]
    rs = [mrng.randrange(pk.n) for _ in range(B)]
    krs = [mrng.randrange(pk.n) for _ in range(B)]

    a, t_enc = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    b, _ = timed(lambda: pk.encrypt_with_randomness(ks, krs))
    prod, t_mult = timed(lambda: pk.mult(a, b))
    t_dec = decrypt_all(sk, pk, tables, prod,
                        [m * kk for m, kk in zip(ms, ks)],
                        "main path DecryptL2 (m*k)", Bd)
    launches_main = read_counts("main", MAIN_PATH)
    gk = hm.GoldenKey(params=sk.a1_params, P=pk.P_host, Q=pk.Q_host, R=sk.r,
                      msg_space=pk.msg_space)
    lanes = [0, 1, B // 2, B - 1]
    pa = convert.affine_to_host(ctx, a[lanes].data)
    pb = convert.affine_to_host(ctx, b[lanes].data)
    for j, i in enumerate(lanes):
        assert pa[j] == hm.golden_encrypt(gk, ms[i], rs[i]), i
        assert pb[j] == hm.golden_encrypt(gk, ks[i], krs[i]), i
    zs = convert.fp2_to_host(ctx, prod[lanes[:2]].data)
    for j in range(2):
        assert zs[j] == hm.tate_pairing(pa[j], pb[j], gk.params), lanes[j]
    log(f"main path: lanes {lanes} equal the host oracle (encrypt, pairing)")
    # a second call of each op: the steady state after the first call
    _, t_enc2 = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    _, t_mult2 = timed(lambda: pk.mult(a, b))
    _, t_dec2 = timed(lambda: sk.decrypt(prod[:Bd], pk, tables))
    for op, n, t1, t2, note in (
            ("Encrypt", B, t_enc, t_enc2, ", host digits included"),
            ("Mult", B, t_mult, t_mult2, ""),
            ("DecryptL2", Bd, t_dec, t_dec2, "")):
        log(f"{op} {n / t1:.1f} ops/s first call, {n / t2:.1f} ops/s second "
            f"call (B={n}{note}) [{card}]")
    phase_done("4 (main path)")

    # -- 4b. the level-1 path end to end (phase 4's ciphertexts) ----------
    zero_counts()
    signs = [mrng.choice((-1, 1)) for _ in range(B)]
    ops = {}
    for op, fn in (("EncryptDeterministic",
                    lambda: pk.encrypt_deterministic(ms)),
                   ("Add", lambda: pk.add(a, b)),
                   ("Sub", lambda: pk.sub(a, b)),
                   ("Neg", lambda: pk.neg(a)),
                   ("MultConst", lambda: pk.mult_const(a, ks)),
                   ("MakeL2", lambda: pk.make_l2(a)),
                   ("MultConstL2", lambda: pk.mult_const(prod, signs)),
                   ("AddL2", lambda: pk.add(prod, b)),
                   ("SubL2", lambda: pk.sub(prod, a))):
        ops[op] = (fn,) + timed(fn)
    t_dec1 = None
    for op, want in (("EncryptDeterministic", ms),
                     ("Add", [m + kk for m, kk in zip(ms, ks)]),
                     ("Sub", [m - kk for m, kk in zip(ms, ks)]),
                     ("Neg", [-m for m in ms]),
                     ("MultConst", [m * kk for m, kk in zip(ms, ks)]),
                     ("MakeL2", ms),
                     ("MultConstL2", [s * m * kk for s, m, kk
                                      in zip(signs, ms, ks)]),
                     ("AddL2", [m * kk + kk for m, kk in zip(ms, ks)]),
                     ("SubL2", [m * kk - m for m, kk in zip(ms, ks)])):
        t = decrypt_all(sk, pk, tables, ops[op][1], want,
                        f"L1 path {op}", Bd)
        if op == "EncryptDeterministic":
            t_dec1 = t
    launches_l1 = read_counts("L1", L1_PATH)
    p = gk.params.p
    host = {
        "EncryptDeterministic": lambda i: hm.ec_mul(ms[i], gk.P, p),
        "Add": lambda i: hm.ec_add(pa[lanes.index(i)], pb[lanes.index(i)], p),
        "Sub": lambda i: hm.ec_add(pa[lanes.index(i)],
                                   hm.ec_neg(pb[lanes.index(i)], p), p),
        "Neg": lambda i: hm.ec_neg(pa[lanes.index(i)], p),
        "MultConst": lambda i: hm.ec_mul(ks[i], pa[lanes.index(i)], p),
    }
    for op, fn in host.items():
        got = convert.affine_to_host(ctx, ops[op][1][lanes].data)
        assert got == [fn(i) for i in lanes], op
    z = convert.fp2_to_host(ctx, ops["MakeL2"][1][lanes[:1]].data)
    assert z[0] == hm.tate_pairing(pa[0], gk.P, gk.params)
    log(f"L1 path: lanes {lanes} equal the host oracle (EncryptDeterministic, "
        "Add, Sub, Neg, MultConst; MakeL2 lane 0)")
    ct1 = ops["EncryptDeterministic"][1]
    _, t_dec1b = timed(lambda: sk.decrypt(ct1[:Bd], pk, tables))
    for op in ops:
        fn, _, t1 = ops[op]
        _, t2 = timed(fn)
        log(f"{op} {B / t1:.1f} ops/s first call, {B / t2:.1f} ops/s second "
            f"call (B={B}) [{card}]")
    log(f"Decrypt (L1) {Bd / t_dec1:.1f} ops/s first call, "
        f"{Bd / t_dec1b:.1f} ops/s second call (B={Bd}) [{card}]")
    phase_done("4b (L1 path)")

    # -- 4c. a 1024-bit key: the wide (S = 6) kernels ----------------------
    t0 = time.time()
    rng2 = random.Random(4321)
    pk2, sk2 = scheme.keygen(1024, 1021, rng=rng2, device="cuda")
    tables2 = pk2.setup_decryption(sk2, rng=rng2)
    k2 = pk2.dev.rns.k
    t_keys["1024 (phase 4c)"] = time.time() - t0
    log(f"keys: 1024-bit, msg space 1021, k = {k2} channels per base "
        f"(S = {cuda_rns.slots_for(k2)}), L = {pk2.dev.ctx.L} limbs, "
        f"{t_keys['1024 (phase 4c)']:.1f} s")
    kernel_checks(pk2, sk2, 64, 64, args.seed + 3)
    exit_check(pk2, EXIT_N_1024, args.seed + 11)
    Bw = args.wide_batch
    wrng = random.Random(args.seed + 4)
    ms2 = [wrng.randrange(340) for _ in range(Bw)]
    ks2 = [wrng.randrange(1, 4) for _ in range(Bw)]
    zero_counts()
    a2, t_enc_w = timed(lambda: pk2.encrypt(ms2, rng=wrng))
    b2, _ = timed(lambda: pk2.encrypt(ks2, rng=wrng))
    prod2, t_mult_w = timed(lambda: pk2.mult(a2, b2))
    t_dec2_w = decrypt_all(sk2, pk2, tables2, prod2,
                           [m * kk for m, kk in zip(ms2, ks2)],
                           "1024-bit DecryptL2 (m*k)", Bw)
    add2, t_add_w = timed(lambda: pk2.add(a2, b2))
    t_dec1_w = decrypt_all(sk2, pk2, tables2, add2,
                           [m + kk for m, kk in zip(ms2, ks2)],
                           "1024-bit Decrypt of Add (m+k)", Bw)
    launches_1024 = read_counts("1024-bit", MAIN_PATH + ("ladder_loop",))
    for op, n, t in (("Encrypt", Bw, t_enc_w), ("Mult", Bw, t_mult_w),
                     ("DecryptL2", Bw, t_dec2_w), ("Add", Bw, t_add_w),
                     ("Decrypt (L1)", Bw, t_dec1_w)):
        log(f"1024-bit {op} {n / t:.1f} ops/s first call (B={n}) [{card}]")
    del add2                   # the 1024-bit key stays for phase 4g
    phase_done("4c (1024-bit)")

    # -- 4d. the limb path: every op of a non-deterministic key ----------
    t0 = time.time()
    pkr, skr = scheme.keygen(512, 1021, deterministic=False,
                             rng=random.Random(args.seed), device="cuda")
    tablesr = pkr.setup_decryption(skr, rng=random.Random(args.seed))
    gkr = hm.GoldenKey(params=skr.a1_params, P=pkr.P_host, Q=pkr.Q_host,
                       R=skr.r, msg_space=pkr.msg_space)
    pr, nr = gkr.params.p, pkr.n
    log(f"keys: 512-bit, msg space 1021, non-deterministic, "
        f"{time.time() - t0:.1f} s")
    nrng = random.Random(args.seed + 5)
    msr = [nrng.randrange(340) for _ in range(B)]
    ksr = [nrng.randrange(1, 4) for _ in range(B)]
    sgr = [nrng.choice((-1, 1)) for _ in range(B)]
    zero_counts()
    # each op draws its r from random.Random(seed) (one per lane, in the
    # JAX package's order), so a host check can replay them
    seeded = {}

    def run(name, seed, fn):
        out, t = timed(lambda: fn(random.Random(seed)))
        seeded[name] = (seed, fn, t)
        return out

    ar = run("Encrypt", 11, lambda g: pkr.encrypt(msr, rng=g))
    br = run("Encrypt b", 12, lambda g: pkr.encrypt(ksr, rng=g))
    prodr = run("Mult", 13, lambda g: pkr.mult(ar, br, rng=g))
    prod2r = run("Mult b*b", 14, lambda g: pkr.mult(br, br, rng=g))
    outs = {
        "AddL2": run("AddL2", 15, lambda g: pkr.add(prodr, prod2r, rng=g)),
        "SubL2": run("SubL2", 16, lambda g: pkr.sub(prodr, prod2r, rng=g)),
        "Add": run("Add", 17, lambda g: pkr.add(ar, br, rng=g)),
        "Sub": run("Sub", 18, lambda g: pkr.sub(ar, br, rng=g)),
        "Neg": run("Neg", 19, lambda g: pkr.neg(ar, rng=g)),
        "MultConst": run("MultConst", 20,
                         lambda g: pkr.mult_const(ar, ksr, rng=g)),
        "MultConst n-1": run("MultConst n-1", 21,
                             lambda g: pkr.mult_const(ar, nr - 1, rng=g)),
        "MultConstL2": run("MultConstL2", 22,
                           lambda g: pkr.mult_const(prodr, sgr, rng=g)),
    }
    # encrypt_device: r from a seeded generator on the card
    outs["EncryptDevice"] = run(
        "EncryptDevice", 23, lambda g: pkr.encrypt_device(
            msr, torch.Generator(device=dev).manual_seed(23)))
    outs["Mult"] = prodr
    wants = {
        "Mult": [m * kk for m, kk in zip(msr, ksr)],
        "AddL2": [m * kk + kk * kk for m, kk in zip(msr, ksr)],
        "SubL2": [m * kk - kk * kk for m, kk in zip(msr, ksr)],
        "Add": [m + kk for m, kk in zip(msr, ksr)],
        "Sub": [m - kk for m, kk in zip(msr, ksr)],
        "Neg": [-m for m in msr],
        "MultConst": [m * kk for m, kk in zip(msr, ksr)],
        "MultConst n-1": [-m for m in msr],
        "MultConstL2": [s_ * m * kk for s_, m, kk in zip(sgr, msr, ksr)],
        "EncryptDevice": msr,
    }
    t_decr = {}
    for name, want in wants.items():
        t_decr[name] = decrypt_all(skr, pkr, tablesr, outs[name], want,
                                   f"limb path {name}", Bd)
    launches_limb = read_counts("limb", LIMB_PATH)

    # a few lanes against hostmath, the r of each op replayed
    def rs_of(name):
        g = random.Random(seeded[name][0])
        return [g.randrange(nr) for _ in range(B)]

    lanes_r = [0, B - 1]
    ctxr = pkr.dev.ctx
    ha = convert.affine_to_host(ctxr, ar[lanes_r].data)
    hb = convert.affine_to_host(ctxr, br[lanes_r].data)
    ra, rb = rs_of("Encrypt"), rs_of("Encrypt b")
    for j, i in enumerate(lanes_r):
        assert ha[j] == hm.golden_encrypt(gkr, msr[i], ra[i]), i
        assert hb[j] == hm.golden_encrypt(gkr, ksr[i], rb[i]), i

    def plus_q(pt, r):
        return hm.ec_add(pt, hm.ec_mul(r, gkr.Q, pr), pr)

    l1_host = {
        "Add": lambda j: hm.ec_add(ha[j], hb[j], pr),
        "Sub": lambda j: hm.ec_add(ha[j], hm.ec_neg(hb[j], pr), pr),
        "Neg": lambda j: hm.ec_neg(ha[j], pr),
        "MultConst": lambda j: hm.ec_mul(ksr[lanes_r[j]], ha[j], pr),
        "MultConst n-1": lambda j: hm.ec_mul(nr - 1, ha[j], pr),
    }
    for name, fn in l1_host.items():
        rr = rs_of(name)
        got = convert.affine_to_host(ctxr, outs[name][lanes_r].data)
        assert got == [plus_q(fn(j), rr[i]) for j, i in enumerate(lanes_r)], \
            name
    eqq = hm.tate_pairing(gkr.Q, gkr.Q, gkr.params)
    hz = {nm: convert.fp2_to_host(ctxr, outs[nm][lanes_r].data)
          for nm in ("Mult", "AddL2", "SubL2", "MultConstL2")}
    hz2 = convert.fp2_to_host(ctxr, prod2r[lanes_r].data)
    hz2_want = [hm.fp2_mul(hm.tate_pairing(u, u, gkr.params), hm.fp2_pow(
        eqq, r, pr), pr) for u, r in zip(hb, [rs_of("Mult b*b")[i]
                                             for i in lanes_r])]
    assert hz2 == hz2_want
    l2_host = {
        "Mult": lambda j: hm.tate_pairing(ha[j], hb[j], gkr.params),
        "AddL2": lambda j: hm.fp2_mul(hz["Mult"][j], hz2[j], pr),
        "SubL2": lambda j: hm.fp2_mul(hz["Mult"][j],
                                      hm.fp2_conj(hz2[j], pr), pr),
        "MultConstL2": lambda j: (hz["Mult"][j] if sgr[lanes_r[j]] > 0
                                  else hm.fp2_conj(hz["Mult"][j], pr)),
    }
    for name, fn in l2_host.items():
        rr = rs_of(name)
        assert hz[name] == [hm.fp2_mul(fn(j), hm.fp2_pow(eqq, rr[i], pr), pr)
                            for j, i in enumerate(lanes_r)], name
    rdev = lb.limbs_to_ints(rng_mod.device_random_below(
        pkr._sampler_ctx, torch.Generator(device=dev).manual_seed(23),
        (scheme._bucket(B),)))
    got = convert.affine_to_host(ctxr, outs["EncryptDevice"][lanes_r].data)
    assert got == [hm.golden_encrypt(gkr, msr[i], rdev[i]) for i in lanes_r]
    log(f"limb path: lanes {lanes_r} equal the host oracle with the r of "
        "each op replayed (Encrypt, Mult, AddL2, SubL2, MultConstL2, Add, "
        "Sub, Neg, MultConst, MultConst n-1, EncryptDevice)")
    for name, (seed, fn, t1) in seeded.items():
        if name in ONE_CALL_4D:
            log(f"{name} (re-randomized) {B / t1:.1f} ops/s first call "
                f"(B={B}) [{card}]")
            continue
        _, t2 = timed(lambda: fn(random.Random(seed)))
        log(f"{name} (re-randomized) {B / t1:.1f} ops/s first call, "
            f"{B / t2:.1f} ops/s second call (B={B}) [{card}]")
    for name in ("Mult", "AddL2", "Add"):
        log(f"Decrypt of limb-path {name} {Bd / t_decr[name]:.1f} ops/s "
            f"(B={Bd}) [{card}]")
    phase_done("4d (limb path, non-deterministic key)")

    # -- 4e. a 2048-bit key: the S = 12 kernels ---------------------------
    t0 = time.time()
    pk3, sk3, tables3, t_child = torch.load(key_path, weights_only=False)
    t_keys["2048 (the child of phases 1-2)"] = t_child
    key_path.unlink()
    pk3.dev.to(dev)
    tables3 = tables3.to(dev)
    k3 = pk3.dev.rns.k
    log(f"keys: 2048-bit, msg space 1021, k = {k3} channels per base "
        f"(S = {cuda_rns.slots_for(k3)}), L = {pk3.dev.ctx.L} limbs; built "
        f"on the host by the child process of phases 1-2 in "
        f"{t_child:.1f} s, loaded and moved to the card in "
        f"{time.time() - t0:.1f} s")
    Bb = args.big_batch
    kernel_checks(pk3, sk3, Bb, Bb, args.seed + 6, trunc=32)
    exit_check(pk3, Bb, args.seed + 12)
    brng = random.Random(args.seed + 7)
    ms3 = [brng.randrange(340) for _ in range(Bb)]
    ks3 = [brng.randrange(1, 4) for _ in range(Bb)]
    zero_counts()
    a3, t_enc3 = timed(lambda: pk3.encrypt(ms3, rng=brng))
    b3, _ = timed(lambda: pk3.encrypt(ks3, rng=brng))
    prod3, t_mult3 = timed(lambda: pk3.mult(a3, b3))
    t_dec3 = decrypt_all(sk3, pk3, tables3, prod3,
                         [m * kk for m, kk in zip(ms3, ks3)],
                         "2048-bit DecryptL2 (m*k)", Bb)
    launches_2048 = read_counts("2048-bit", MAIN_PATH)
    for op, t in (("Encrypt", t_enc3), ("Mult", t_mult3),
                  ("DecryptL2", t_dec3)):
        log(f"2048-bit {op} {Bb / t:.2f} ops/s first call (B={Bb}) [{card}]")
    del pk3, sk3, tables3, a3, b3, prod3
    phase_done("4e (2048-bit)")

    # -- 4f. the per-step configuration on phase 2's key -----------------
    BGNParams(rns_pallas="1").apply_kernel_modes()
    zero_counts()
    a_s, t_enc_s = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    b_s, _ = timed(lambda: pk.encrypt_with_randomness(ks, krs))
    for got_ct, want_ct in ((a_s, a), (b_s, b)):
        if not all(torch.equal(u, v) for u, v in zip(got_ct.data,
                                                     want_ct.data)):
            raise AssertionError("step-mode Encrypt != phase 4's Encrypt")
    prod_s, t_mult_s = timed(lambda: pk.mult(a_s, b_s))
    if not torch.equal(prod_s.data, prod.data):
        raise AssertionError("step-mode Mult != phase 4's Mult")
    log(f"step mode: Encrypt (split path) and Mult equal phase 4's outputs "
        f"on all {B} lanes")
    t_dec_s = decrypt_all(sk, pk, tables, prod_s,
                          [m * kk for m, kk in zip(ms, ks)],
                          "step-mode DecryptL2 (m*k)", Bd)
    a_l, b_l = a_s[:Bd], b_s[:Bd]
    ms_l, ks_l = ms[:Bd], ks[:Bd]
    ops_s = {}
    for op, fn, want in (
            ("EncryptDeterministic", lambda: pk.encrypt_deterministic(ms_l),
             ms_l),
            ("Add", lambda: pk.add(a_l, b_l),
             [m + kk for m, kk in zip(ms_l, ks_l)]),
            ("Sub", lambda: pk.sub(a_l, b_l),
             [m - kk for m, kk in zip(ms_l, ks_l)]),
            ("Neg", lambda: pk.neg(a_l), [-m for m in ms_l]),
            ("MultConst", lambda: pk.mult_const(a_l, ks_l),
             [m * kk for m, kk in zip(ms_l, ks_l)]),
            ("MakeL2", lambda: pk.make_l2(a_l), ms_l)):
        out, t1 = timed(fn)
        t_d = decrypt_all(sk, pk, tables, out, want, f"step-mode {op}", Bd)
        ops_s[op] = (fn, t1, t_d)
    launches_step = read_counts("step", STEP_PATH)
    for name in LOOP_ONLY:
        if launches_step[name]:
            raise AssertionError(f"{name} launched {launches_step[name]} "
                                 "times in step mode")
    log(f"step mode: no launch of {', '.join(LOOP_ONLY)}")
    _, t_enc_s2 = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    _, t_mult_s2 = timed(lambda: pk.mult(a_s, b_s))
    _, t_dec_s2 = timed(lambda: sk.decrypt(prod_s[:Bd], pk, tables))
    for op, n, t1, t2 in (("Encrypt", B, t_enc_s, t_enc_s2),
                          ("Mult", B, t_mult_s, t_mult_s2),
                          ("DecryptL2", Bd, t_dec_s, t_dec_s2)):
        log(f"step-mode {op} {n / t1:.1f} ops/s first call, {n / t2:.1f} "
            f"ops/s second call (B={n}) [{card}]")
    for op, (fn, t1, t_d) in ops_s.items():
        _, t2 = timed(fn)
        log(f"step-mode {op} {Bd / t1:.1f} ops/s first call, "
            f"{Bd / t2:.1f} ops/s second call (B={Bd}); its decrypt "
            f"{Bd / t_d:.1f} ops/s [{card}]")
    BGNParams(rns_pallas="loop").apply_kernel_modes()
    phase_done("4f (per-step configuration)")

    # -- 4g. the limb-domain configuration on phase 2's key --------------
    def ct_equal(u, v):
        if u.level2:
            return torch.equal(u.data, v.data)
        return all(torch.equal(x, y) for x, y in zip(u.data, v.data))

    BGNParams(rns_miller="0").apply_kernel_modes()
    zero_counts()
    a_g, t_enc_g = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    b_g, _ = timed(lambda: pk.encrypt_with_randomness(ks, krs))
    if not (ct_equal(a_g, a) and ct_equal(b_g, b)):
        raise AssertionError("limb-mode Encrypt != phase 4's Encrypt")
    digit_names = DIGIT_PATH[:2]
    before = {nm: wrappers[nm].launches for nm in digit_names}
    prod_g, t_mult_g = timed(lambda: pk.mult(a_g, b_g))
    per_mult = {nm: wrappers[nm].launches - before[nm] for nm in digit_names}
    if not ct_equal(prod_g, prod):
        raise AssertionError("limb-mode Mult != phase 4's Mult")
    log(f"limb mode: Encrypt and Mult equal phase 4's outputs on all {B} "
        "lanes")
    nbits = [int(v) for v in pk.dev.n_bits.cpu().tolist()]
    first = nbits[:-1].index(1)
    want_steps = {"miller_dbl_digits": len(nbits) - first - 1,
                  "miller_add_digits": sum(nbits[first + 1:-1])}
    if per_mult != want_steps:
        raise AssertionError(f"digit steps per Mult {per_mult}, the bits "
                             f"of n give {want_steps}")
    log(f"limb mode: one Mult launched {per_mult['miller_dbl_digits']} "
        f"doubling and {per_mult['miller_add_digits']} addition steps (n "
        f"has {pk.n.bit_length()} bits and popcount {bin(pk.n).count('1')}"
        ": bits - 1 and popcount - 2)")
    # prod_g equals phase 4's Mult, decrypted there on every lane: the
    # limb-mode decrypt runs on its first Bd lanes (phase 4j's time)
    t_dec_g = decrypt_all(sk, pk, tables, prod_g[:Bd],
                          [m * kk for m, kk in zip(ms[:Bd], ks[:Bd])],
                          "limb-mode DecryptL2 (m*k)", Bd)
    a_l, b_l = a_g[:Bd], b_g[:Bd]
    ms_l, ks_l, sg_l = ms[:Bd], ks[:Bd], signs[:Bd]
    kn_l = [sg * kk for sg, kk in zip(sg_l, ks_l)]
    ops_g = {}
    for op, fn, want, ref in (
            ("EncryptDeterministic", lambda: pk.encrypt_deterministic(ms_l),
             ms_l, "EncryptDeterministic"),
            ("Add", lambda: pk.add(a_l, b_l),
             [m + kk for m, kk in zip(ms_l, ks_l)], "Add"),
            ("Sub", lambda: pk.sub(a_l, b_l),
             [m - kk for m, kk in zip(ms_l, ks_l)], "Sub"),
            ("Neg", lambda: pk.neg(a_l), [-m for m in ms_l], "Neg"),
            ("MultConst", lambda: pk.mult_const(a_l, kn_l),
             [m * kk for m, kk in zip(ms_l, kn_l)], None),
            ("MakeL2", lambda: pk.make_l2(a_l), ms_l, "MakeL2"),
            ("MultConstL2", lambda: pk.mult_const(prod_g[:Bd], sg_l),
             [sg * m * kk for sg, m, kk in zip(sg_l, ms_l, ks_l)],
             "MultConstL2")):
        out, t1 = timed(fn)
        if ref is not None and not ct_equal(out, ops[ref][1][:Bd]):
            raise AssertionError(f"limb-mode {op} != the default "
                                 "configuration's")
        t_d = decrypt_all(sk, pk, tables, out, want, f"limb-mode {op}", Bd)
        ops_g[op] = (fn, t1, t_d)
    log(f"limb mode: EncryptDeterministic, Add, Sub, Neg, MakeL2 and "
        f"MultConstL2 equal the default configuration's on {Bd} lanes")

    # phase 4d's non-deterministic key: the same r, so phase 4d's lanes
    Bn = args.limb_batch
    nd_ops = {
        "Encrypt": (lambda g: pkr.encrypt(msr[:Bn], rng=g), ar, msr),
        "Mult": (lambda g: pkr.mult(ar[:Bn], br[:Bn], rng=g),
                 outs["Mult"], wants["Mult"]),
        "Add": (lambda g: pkr.add(ar[:Bn], br[:Bn], rng=g), outs["Add"],
                wants["Add"]),
        "Neg": (lambda g: pkr.neg(ar[:Bn], rng=g), outs["Neg"],
                wants["Neg"]),
        "MultConst": (lambda g: pkr.mult_const(ar[:Bn], ksr[:Bn], rng=g),
                      outs["MultConst"], wants["MultConst"]),
        "MultConst n-1": (lambda g: pkr.mult_const(ar[:Bn], nr - 1, rng=g),
                          outs["MultConst n-1"], wants["MultConst n-1"]),
        "MultConstL2": (lambda g: pkr.mult_const(prodr[:Bn], sgr[:Bn],
                                                 rng=g),
                        outs["MultConstL2"], wants["MultConstL2"]),
    }
    for name, (fn, ref, want) in nd_ops.items():
        out = fn(random.Random(seeded[name][0]))
        if not ct_equal(out, ref[:Bn]):
            raise AssertionError(f"limb-mode re-randomized {name} != phase "
                                 "4d's lanes")
        decrypt_all(skr, pkr, tablesr, out, want[:Bn],
                    f"limb-mode re-randomized {name}", Bn)
    dv = pkr.encrypt_device(msr[:Bn],
                            torch.Generator(device=dev).manual_seed(23))
    decrypt_all(skr, pkr, tablesr, dv, msr[:Bn], "limb-mode EncryptDevice",
                Bn)
    log(f"limb mode: the non-deterministic key's ops equal phase 4d's "
        f"first {Bn} lanes")

    # the limb Miller loop: fused_miller=False, and a 1024-bit key (L = 66)
    BGNParams(fused_miller=False).apply_kernel_modes()
    prod_nf = pk.mult(a_g[:Bn], b_g[:Bn])
    BGNParams(fused_miller=True).apply_kernel_modes()
    if not ct_equal(prod_nf, prod_g[:Bn]):
        raise AssertionError("fused_miller=False Mult != the fused Mult")
    log(f"limb mode: the limb Miller loop equals the fused one on {Bn} "
        "lanes")
    prod2_g, t_mult2_g = timed(lambda: pk2.mult(a2[:Bn], b2[:Bn]))
    if not ct_equal(prod2_g, prod2[:Bn]):
        raise AssertionError("1024-bit limb-mode Mult != phase 4c's Mult")
    t_dec2_g = decrypt_all(sk2, pk2, tables2, prod2_g,
                           [m * kk for m, kk in zip(ms2[:Bn], ks2[:Bn])],
                           "1024-bit limb-mode DecryptL2 (m*k)", Bn)
    launches_digit = read_counts("limb-domain", DIGIT_PATH)
    rns_launched = {nm: launches_digit[nm] for nm in wrappers
                    if nm not in DIGIT_PATH and launches_digit[nm]}
    if rns_launched:
        raise AssertionError(f"RNS kernels launched in limb mode: "
                             f"{rns_launched}")
    log("limb mode: no launch of the 14 RNS kernels")
    _, t_enc_g2 = timed(lambda: pk.encrypt_with_randomness(ms, rs))
    _, t_mult_g2 = timed(lambda: pk.mult(a_g, b_g))
    _, t_dec_g2 = timed(lambda: sk.decrypt(prod_g[:Bd], pk, tables))
    for op, n, t1, t2 in (("Encrypt", B, t_enc_g, t_enc_g2),
                          ("Mult", B, t_mult_g, t_mult_g2),
                          ("DecryptL2", Bd, t_dec_g, t_dec_g2)):
        log(f"limb-mode {op} {n / t1:.1f} ops/s first call, {n / t2:.1f} "
            f"ops/s second call (B={n}) [{card}]")
    for op, (fn, t1, t_d) in ops_g.items():
        _, t2 = timed(fn)
        log(f"limb-mode {op} {Bd / t1:.1f} ops/s first call, "
            f"{Bd / t2:.1f} ops/s second call (B={Bd}); its decrypt "
            f"{Bd / t_d:.1f} ops/s [{card}]")
    log(f"1024-bit limb-mode Mult {Bn / t_mult2_g:.2f} ops/s, DecryptL2 "
        f"{Bn / t_dec2_g:.2f} ops/s first call (B={Bn}) [{card}]")
    BGNParams(rns_miller="auto").apply_kernel_modes()
    del pk2, sk2, tables2, a2, b2, prod2, prod2_g
    phase_done("4g (limb-domain configuration)")

    # -- 4h. phase 2's key without its RNS context: every op on limbs ----
    def no_pool(*_args, **_kwargs):
        raise ValueError("modulus too large for the 12-bit RNS prime pool")

    make_rns_ctx = rn.make_rns_ctx
    rn.make_rns_ctx = no_pool
    try:
        pkn, skn = scheme.keygen(512, 1021, rng=random.Random(args.seed),
                                 device="cuda")
    finally:
        rn.make_rns_ctx = make_rns_ctx
    if pkn.dev.rns is not None or pkn.dev.p_win is not None \
            or pkn.p != pk.p:
        raise AssertionError("the key rebuilt without RNS is not phase 2's "
                             "key with rns None")
    zero_counts()
    Bn = args.limb_batch
    a_h, t_enc_h = timed(lambda: pkn.encrypt_with_randomness(ms[:Bn],
                                                             rs[:Bn]))
    b_h, _ = timed(lambda: pkn.encrypt_with_randomness(ks[:Bn], krs[:Bn]))
    if not (ct_equal(a_h, a_g[:Bn]) and ct_equal(b_h, b_g[:Bn])):
        raise AssertionError("no-RNS key Encrypt != phase 4g's")
    prod_h, t_mult_h = timed(lambda: pkn.mult(a_h, b_h))
    if not ct_equal(prod_h, prod_g[:Bn]):
        raise AssertionError("no-RNS key Mult != phase 4g's")
    t_dec_h = decrypt_all(skn, pkn, tables, prod_h,
                          [m * kk for m, kk in zip(ms[:Bn], ks[:Bn])],
                          "no-RNS key DecryptL2 (m*k)", Bn)
    launches_norns = read_counts("no-RNS key", DIGIT_PATH)
    rns_launched = {w.__name__: launches_norns[w.__name__]
                    for w in cuda_rns.WRAPPERS if launches_norns[w.__name__]}
    if rns_launched:
        raise AssertionError(f"RNS kernels launched for a key without an "
                             f"RNS context: {rns_launched}")
    log(f"no-RNS key: Encrypt and Mult equal phase 4g's limb-mode outputs "
        f"on {Bn} lanes; no launch of the 14 RNS kernels")
    for op, t in (("Encrypt", t_enc_h), ("Mult", t_mult_h),
                  ("DecryptL2", t_dec_h)):
        log(f"no-RNS key {op} {Bn / t:.1f} ops/s first call (B={Bn}) "
            f"[{card}]")
    del b_h                    # the key and a_h, prod_h stay for phase 4k
    phase_done("4h (key without an RNS context)")

    # -- 4i. the poly path, serialized, and the models -------------------
    from bgn_torch import encoding, polyct as pc, serialize as ser
    from bgn_torch.models import aggregation as agg, encrypted_dot as edot
    from bgn_torch.ops.curve import AffinePoint
    zero_counts()
    t0 = time.time()
    pkp = ser.public_key_from_json(ser.public_key_to_json(pk), device="cuda")
    sd, sdp = pk.dev.state_dict(), pkp.dev.state_dict()
    if sd.keys() != sdp.keys() or not all(torch.equal(sd[nm], sdp[nm])
                                          for nm in sd) \
            or (pkp.dev.rns.k, pkp.dev.rns.h, pkp.dev.ctx.p_host) \
            != (rns.k, rns.h, ctx.p_host):
        raise AssertionError("the key reloaded from JSON is not phase 2's")
    log(f"poly: phase 2's key through public_key_to_json -> "
        f"public_key_from_json on the card, all {len(sd)} tensors equal "
        f"({time.time() - t0:.1f} s, host)")
    Bp = POLY_B
    prng = random.Random(args.seed + 9)

    def poly_decrypt(label, pct, coeffs, value, whole=False):
        """Every coefficient of every lane, Bd lanes at a time (as
        decrypt_all), against the host coefficient lists (one per poly);
        then each poly decoded from the decrypted coefficients (poly_eval)
        against value at %.1f, as poly_test.go compares.  whole: also
        decrypt_poly_batch, the client's entry point (its failed lanes
        would come back as 0), in one call, each returned PolyPlaintext's
        coefficients, degree and scale against the host's and decoded the
        same way.  Returns the seconds of the first chunk and of the
        decrypt_poly_batch call (None without whole)."""
        d, nb, sf = *pct.ct.batch_shape, pct.scale_factor
        want = [c[i] if i < len(c) else 0 for i in range(d) for c in coeffs]
        got = []
        t = decrypt_all(sk, pkp, tables, pct.ct.reshape((d * nb,)), want,
                        f"poly {label} (degree {d}, B={nb})", Bd, out=got)
        decoded = {"decrypt-batch chunks": [encoding.PolyPlaintext(
            pkp, [got[i * nb + b] for i in range(d)], d, sf)
            for b in range(nb)]}
        t_whole = None
        if whole:
            pts, t_whole = timed(lambda: pc.decrypt_poly_batch(sk, pct, pkp,
                                                               tables))
            bad = [b for b, p in enumerate(pts)
                   if (p.coefficients, p.degree, p.scale_factor)
                   != ([want[i * nb + b] for i in range(d)], d, sf)]
            if len(pts) != nb or bad:
                raise AssertionError(f"poly {label}: decrypt_poly_batch gives "
                                     f"{len(pts)} polys, {len(bad)} wrong")
            decoded["decrypt_poly_batch"] = pts
        for how, pts in decoded.items():
            vals = [p.poly_eval() for p in pts]
            bad = [b for b, v in enumerate(vals)
                   if f"{v:.1f}" != f"{value:.1f}"]
            if bad:
                raise AssertionError(f"poly {label} ({how}): {len(bad)} lanes "
                                     f"decode to {vals[bad[0]]:.4f}, not "
                                     f"{value:.1f}")
        log(f"poly {label}: every lane decodes to {value:.1f} "
            f"({', '.join(decoded)})")
        return t, t_whole

    def first_polys(pct, n):
        """The first n polys of a (degree, B) poly batch."""
        d = pct.ct.data
        data = d[..., :n] if pct.level2 else AffinePoint(
            d.x[..., :n], d.y[..., :n], d.inf[..., :n])
        return pc.PolyCiphertext(scheme.Ciphertext(data, pct.level2),
                                 pct.degree, pct.scale_factor)

    def conv(u, v):
        return [sum(u[i] * v[j - i] for i in range(len(u)) if 0 <= j - i
                    < len(v)) for j in range(len(u) + len(v))]

    # encode and encrypt: B polys of 100.1 (balanced degree 13, scale 8),
    # 2B of 7.0 (degree 3) and 2B seeded integers below 340 (scale 0)
    t0 = time.time()
    pt_x = [encoding.new_poly_plaintext(pkp, 100.1) for _ in range(Bp)]
    pt_s = [encoding.new_poly_plaintext(pkp, 7.0) for _ in range(2 * Bp)]
    ints = [prng.randrange(340) for _ in range(2 * Bp)]
    pt_i = [encoding.new_poly_plaintext(pkp, float(v)) for v in ints]
    t_encode = time.time() - t0
    X, t_encp = timed(lambda: pc.encrypt_poly_batch(pk, pt_x, rng=prng))
    S, _ = timed(lambda: pc.encrypt_poly_batch(pk, pt_s, rng=prng))
    I_, _ = timed(lambda: pc.encrypt_poly_batch(pk, pt_i, rng=prng))
    log(f"poly: encoded {4 * Bp} values in {t_encode:.2f} s (host); "
        f"batches {X.ct.batch_shape}, {S.ct.batch_shape}, "
        f"{I_.ct.batch_shape}; scale factors {X.scale_factor}, "
        f"{S.scale_factor}, {I_.scale_factor}")
    # serialize: the client's bytes, loaded (validated) on the server
    blob, t_ser = timed(lambda: ser.poly_ciphertext_to_bytes(pk, X))
    Xs, t_load = timed(lambda: ser.poly_ciphertext_from_bytes(pkp, blob,
                                                              device="cuda"))
    if not ct_equal(Xs.ct, X.ct) or (Xs.degree, Xs.scale_factor) != \
            (X.degree, X.scale_factor):
        raise AssertionError("poly ciphertext bytes round trip != original")
    log(f"poly: {len(blob)} bytes for the 100.1 batch, to_bytes "
        f"{t_ser:.2f} s, from_bytes (validated) {t_load:.2f} s, equal")
    cx, cs = pt_x[0].coefficients, pt_s[0].coefficients
    ci = [p.coefficients for p in pt_i]
    t_decp, t_decb1 = poly_decrypt("100.1 after the bytes round trip", Xs,
                                   [cx] * Bp, 100.1, whole=True)
    poly_decrypt("7.0", S, [cs] * 2 * Bp, 7.0)
    decrypt_all(sk, pkp, tables, I_.ct.reshape((-1,)),
                [c[i] if i < len(c) else 0 for i in range(I_.degree)
                 for c in ci], f"poly integers (degree {I_.degree})", Bd)
    # the server's ops on the reloaded key
    A, t_addp = timed(lambda: pc.add_poly(pkp, Xs, Xs))
    Sb, _ = timed(lambda: pc.sub_poly(pkp, A, Xs))
    Ng, _ = timed(lambda: pc.neg_poly(pkp, Xs))
    C1, t_mcp = timed(lambda: pc.mult_const_poly(pkp, Xs, 1.0))
    C2, _ = timed(lambda: pc.mult_const_poly(pkp, Xs, -2.5))
    M, t_multp = timed(lambda: pc.mult_poly(pkp, Xs, Xs))
    U, _ = timed(lambda: pc.make_poly_l2(pkp, Xs))
    AL2, _ = timed(lambda: pc.add_poly(pkp, M, U))
    ES, t_evalp = timed(lambda: pc.eval_poly(pkp, S))
    EI, _ = timed(lambda: pc.eval_poly(pkp, I_))
    u1 = encoding.new_unbalanced_plaintext(pkp, 1.0).coefficients
    u25 = [-c for c in encoding.new_unbalanced_plaintext(
        pkp, 2.5).coefficients]
    # AddPoly aligns MakePolyL2's scale 8 to MultPoly's 16: MultConstPoly
    # by 3^8, whose unbalanced encoding x^8 shifts the coefficients
    aligned = conv(conv([1], cx), encoding.new_unbalanced_plaintext(
        pkp, 3.0 ** 8).coefficients)
    log(f"poly: AddPoly, SubPoly, NegPoly (degree {A.degree}), "
        f"MultConstPoly by 1.0 (degree {C1.degree}) and -2.5 (degree "
        f"{C2.degree}, {X.degree * (C2.degree - X.degree)} x {Bp} "
        f"MultConst lanes), MultPoly (degree {M.degree}, "
        f"{X.degree ** 2} x {Bp} = {X.degree ** 2 * Bp} pairings), "
        f"MakePolyL2 and AddPoly at L2, EvalPoly of the 7.0 and integer "
        f"batches")
    # the results' bytes: the server's files, loaded by the key holder
    back = {}
    for name, r in (("MultPoly", M), ("AddPoly L2", AL2), ("EvalPoly", ES)):
        pct = r if isinstance(r, pc.PolyCiphertext) else \
            pc.PolyCiphertext(r, 1, 0)
        back[name] = ser.poly_ciphertext_from_bytes(
            pk, ser.poly_ciphertext_to_bytes(pkp, pct), device="cuda")
        if not ct_equal(back[name].ct, pct.ct):
            raise AssertionError(f"{name} bytes round trip != original")
    log("poly: MultPoly, AddPoly L2 and EvalPoly results through bytes "
        "(validated), equal")
    # the ops on the 100.1 batch (every poly the same plaintext): the
    # first POLY_CHECK polys of each result decrypted (phase 4j's time)
    for label, pct, coeffs, value in (
            ("AddPoly (x + x)", A, [2 * c for c in cx], 200.2),
            ("SubPoly ((x + x) - x)", Sb, cx, 100.1),
            ("NegPoly", Ng, [-c for c in cx], -100.1),
            ("MultConstPoly by 1.0", C1, conv(cx, u1), 100.1),
            ("MultConstPoly by -2.5", C2, conv(cx, u25), -250.25),
            ("MakePolyL2", U, conv([1], cx), 100.1),
            ("AddPoly L2 (after bytes)", back["AddPoly L2"],
             [a + b for a, b in zip(conv(cx, cx), aligned + [0] * M.degree)],
             100.1 * 100.1 + 100.1)):
        poly_decrypt(label, first_polys(pct, POLY_CHECK),
                     [coeffs] * POLY_CHECK, value)
    poly_decrypt("MultPoly (after bytes)", back["MultPoly"],
                 [conv(cx, cx)] * Bp, 100.1 * 100.1, whole=True)
    decrypt_all(sk, pkp, tables, back["EvalPoly"].ct.reshape((-1,)),
                [7] * 2 * Bp, "poly EvalPoly of 7.0 (after bytes)", Bd)
    decrypt_all(sk, pkp, tables, EI.reshape((-1,)), ints,
                "poly EvalPoly of the integers", Bd)
    # a few lanes against hostmath: E(c) of the first coefficients and one
    # MultPoly coefficient as the product of pairings
    h0 = convert.affine_to_host(ctx, X.ct[0][:2].data)
    h1 = convert.affine_to_host(ctx, X.ct[1][:2].data)
    m1 = convert.fp2_to_host(ctx, M.ct[1][:2].data)
    for lane in range(2):
        want = hm.fp2_mul(hm.tate_pairing(h0[lane], h1[lane], gk.params),
                          hm.tate_pairing(h1[lane], h0[lane], gk.params),
                          gk.params.p)
        if m1[lane] != want:
            raise AssertionError(f"MultPoly coefficient 1, lane {lane} != "
                                 "the host product of pairings")
        if hm.golden_decrypt_l1(gk, h0[lane]) != cx[0]:
            raise AssertionError(f"coefficient 0, lane {lane}: host decrypt")
    log("poly: lanes 0, 1 equal the host oracle (coefficient 0's decrypt, "
        "MultPoly coefficient 1 = e(c0, c1) e(c1, c0))")
    # rates: a second call of each op at B = Bp (the 100.1 batch)
    _, t_encp2 = timed(lambda: pc.encrypt_poly_batch(pk, pt_x, rng=prng))
    _, t_multp2 = timed(lambda: pc.mult_poly(pkp, Xs, Xs))
    _, t_mcp2 = timed(lambda: pc.mult_const_poly(pkp, Xs, 1.0))
    _, t_addp2 = timed(lambda: pc.add_poly(pkp, Xs, Xs))
    _, t_evalp1 = timed(lambda: pc.eval_poly(pkp, Xs))
    _, t_evalp2 = timed(lambda: pc.eval_poly(pkp, Xs))
    _, t_decb2 = timed(lambda: pc.decrypt_poly_batch(sk, Xs, pkp, tables))
    for op, t1, t2, note in (
            ("EncryptPoly", t_encp, t_encp2, ", host randomness included"),
            ("MultPoly", t_multp, t_multp2, ""),
            ("MultConstPoly (1.0)", t_mcp, t_mcp2, ""),
            ("AddPoly", t_addp, t_addp2, ""),
            ("EvalPoly", t_evalp1, t_evalp2, ""),
            ("DecryptPoly (decrypt_poly_batch, one call)", t_decb1, t_decb2,
             "")):
        log(f"{op} {Bp / t1:.1f} polys/s first call, {Bp / t2:.1f} polys/s "
            f"second call (B={Bp} polys of 100.1, degree {X.degree}{note}) "
            f"[{card}]")
    log(f"DecryptPoly in decrypt-batch chunks: {Bd / t_decp:.1f} "
        f"coefficients/s first chunk (B={Bd}) [{card}]")
    # models: encrypted_dot at D = 64, B = 128, x, y < 4 (<x, y> <= 576)
    D, Bm = DOT_D, DOT_B
    vrng = random.Random(args.seed + 10)
    xv = [[vrng.randrange(4) for _ in range(D)] for _ in range(Bm)]
    yv = [[vrng.randrange(4) for _ in range(D)] for _ in range(Bm)]
    flat_x = [xv[b][i] for i in range(D) for b in range(Bm)]
    flat_y = [yv[b][i] for i in range(D) for b in range(Bm)]
    dots = [sum(u * v for u, v in zip(xv[b], yv[b])) for b in range(Bm)]
    xd = pk.encrypt(flat_x, rng=vrng).reshape((D, Bm))
    yd = pk.encrypt(flat_y, rng=vrng).reshape((D, Bm))
    dot, t_dot = timed(lambda: edot.encrypted_dot(pkp, xd, yd))
    ref, t_ref = timed(lambda: agg.aggregate(pkp, pkp.mult(xd, yd)))
    if not torch.equal(dot.data, ref.data):
        raise AssertionError("encrypted_dot != Mult + aggregate")
    decrypt_all(sk, pkp, tables, dot, dots, f"encrypted_dot (D={D}, "
                f"B={Bm})", Bd)
    _, t_dot2 = timed(lambda: edot.encrypted_dot(pkp, xd, yd))
    l1sum, t_agg = timed(lambda: agg.aggregate(pkp, xd))
    decrypt_all(sk, pkp, tables, l1sum, [sum(u) for u in xv],
                f"aggregate L1 (N={D}, B={Bm})", Bd)
    xr_ = pkr.encrypt(flat_x, rng=vrng).reshape((D, Bm))
    yr_ = pkr.encrypt(flat_y, rng=vrng).reshape((D, Bm))
    fused = edot.encrypted_dot(pkr, xr_, yr_)
    wag, t_wag = timed(lambda: agg.weighted_aggregate(pkr, xr_, yr_))
    if torch.equal(wag.data, fused.data):
        raise AssertionError("weighted_aggregate (rng=None) of a "
                             "non-deterministic key is not re-randomized")
    decrypt_all(skr, pkr, tablesr, wag, dots, "weighted_aggregate "
                "(non-deterministic key, rng=None: fused, re-randomized)", Bd)
    log(f"models: encrypted_dot equals Mult + aggregate on all {Bm} "
        f"outputs; weighted_aggregate re-randomizes the fused value")
    log(f"encrypted_dot {Bm / t_dot:.1f} outputs/s first call, "
        f"{Bm / t_dot2:.1f} outputs/s second call; Mult + aggregate "
        f"{Bm / t_ref:.1f} outputs/s; aggregate L1 {Bm / t_agg:.1f} "
        f"outputs/s; weighted_aggregate (re-randomized) {Bm / t_wag:.1f} "
        f"outputs/s (D={D}, B={Bm}) [{card}]")
    launches_poly = read_counts("poly", POLY_PATH)
    del A, Sb, Ng, C1, C2, U, AL2, back, xr_, yr_, fused, wag
    phase_done("4i (poly path, serialization, models)")

    # -- 4j. the Go reference's wire format and the ZK gadgets -----------
    import hashlib

    from bgn_torch import gadgets as gd
    from bgn_torch.interop import gob, pbc
    from bgn_torch.ops import sha256 as sha
    zero_counts()
    routes0 = dict(gd.route_counts)
    parts, part_t = [], [time.time()]      # 4j's seconds by part

    def part(name):
        now = time.time()
        parts.append(f"{name} {now - part_t[0]:.2f} s")
        part_t[0] = now

    # (1) gob: phase 2's public key, Bd L1 lanes of phase 4's Encrypt
    # output, Bd L2 lanes of its Mult output and GOB_POLYS polys of the
    # 100.1 batch, each exported and imported on the card
    kblob, t_kx = timed(lambda: iref.public_key_to_gob(pk))
    pkg, t_ki = timed(lambda: iref.public_key_from_gob(kblob, device="cuda"))
    # the wire format has no key_bits: the import's is n's bit length (as
    # in the JAX package), so its bits of n lack keygen's leading zeros
    sd, sdg = pk.dev.state_dict(), pkg.dev.state_dict()
    nb, nbg = sd.pop("n_bits"), sdg.pop("n_bits")
    if any(getattr(pkg, f) != getattr(pk, f) for f in (
            "n", "l", "p", "P_host", "Q_host", "msg_space", "deterministic",
            "poly_params", "n_digits_kind")) \
            or pkg.key_bits != pk.n.bit_length() \
            or gob.loads(kblob)["PairingParams"] \
            != pbc.a1_params_to_str(pk.p, pk.n, pk.l) \
            or sd.keys() != sdg.keys() \
            or not all(torch.equal(sd[nm], sdg[nm]) for nm in sd) \
            or not torch.equal(nb[len(nb) - len(nbg):], nbg) \
            or bool(nb[:len(nb) - len(nbg)].any()):
        raise AssertionError("the key through gob is not phase 2's")
    log(f"gob: phase 2's public key, {len(kblob)} bytes, export "
        f"{t_kx:.3f} s, import on the card {t_ki:.2f} s: n, l, p, P, Q, "
        f"the params string, msg space and poly parameters equal, the "
        f"other {len(sd)} tensors equal, key_bits {pkg.key_bits} = n's bit "
        f"length (keygen's {pk.key_bits})")
    part("gob key")
    for label, ct, want in (("L1 (phase 4's Encrypt)", a[:Bd], ms[:Bd]),
                            ("L2 (phase 4's Mult)", prod[:Bd],
                             [m * kk for m, kk in zip(ms[:Bd], ks[:Bd])])):
        blobs, t_x = timed(lambda ct=ct: iref.ciphertext_to_gob(pk, ct))
        back, t_i = timed(lambda b=blobs: iref.ciphertext_from_gob(
            pkg, b, device="cuda"))
        if not ct_equal(back, ct):
            raise AssertionError(f"gob {label}: the round trip != original")
        log(f"gob {label}: {Bd} blobs of {len(blobs[0])} bytes, export "
            f"{t_x:.2f} s, import (validated) {t_i:.2f} s, equal "
            f"[{card}]")
        decrypt_all(sk, pkg, tables, back, want, f"gob {label}", Bd)
    part("gob L1 and L2 with their decrypts")
    for i in range(GOB_POLYS):
        col = pc.PolyCiphertext(scheme.Ciphertext(AffinePoint(
            X.ct.data.x[:, :, i], X.ct.data.y[:, :, i],
            X.ct.data.inf[:, i]), False), X.degree, X.scale_factor)
        back = iref.poly_ciphertext_from_gob(
            pkg, iref.poly_ciphertext_to_gob(pk, col), device="cuda")
        dec = pc.decrypt_poly(sk, back, pkg, tables)
        if not ct_equal(back.ct, col.ct) or (back.degree, back.scale_factor) \
                != (X.degree, X.scale_factor) \
                or dec.coefficients != cx or f"{dec.poly_eval():.1f}" \
                != "100.1":
            raise AssertionError(f"gob poly {i} of the 100.1 batch")
    log(f"gob: polys 0-{GOB_POLYS - 1} of the 100.1 batch (degree "
        f"{X.degree}) through poly_ciphertext_to_gob / _from_gob, equal, "
        "decrypted to 100.1")
    part("gob polys")
    # (2) conformance: the synthesized vectors, the device check on the card
    counts, t_conf = timed(lambda: iconf.verify_reference_vectors(
        vec64, device="cuda"))
    if counts != {"key": 1, "pairing": 1, "encrypt": 7, "ops": 7,
                  "device_encrypt": 7}:
        raise AssertionError(f"conformance counts {counts}")
    log(f"conformance: the synthesized 64-bit vectors {counts}, the device "
        f"encryptions byte-equal on the card ({t_conf:.2f} s)")
    part("conformance")
    # (3) the gadgets on phase 2's key at Bd lanes of phase 4's (m, r)
    gv, gr, gct = ms[:Bd], rs[:Bd], a[:Bd]
    ok, t_dpc = timed(lambda: gd.check_decryption_proof(
        pk, gct, gd.new_decryption_proof(gv, gr)))
    bad = gd.check_decryption_proof(pk, gct, gd.new_decryption_proof(
        gv, [gr[0] + 1] + gr[1:]))
    if not ok.all() or bad.tolist() != [False] + [True] * (Bd - 1):
        raise AssertionError("decryption proofs: honest or tampered wrong")
    part("decryption proofs")
    grng = random.Random(args.seed + 11)
    proof, t_prove = timed(lambda: gd.new_proof_of_plaintext_knowledge(
        pk, sk, gv, gr, rng=grng))
    # one verify of the batch with three lanes tampered: lane 0's DL, lane
    # 1's nonce (lane 2's), lane 3 against lane 4's ciphertext
    dl = list(proof.dl)
    dl[0] = (dl[0] + 1) % pk.n
    nz = AffinePoint(*(t.clone() for t in proof.nonce.data))
    nz.x[:, 1], nz.y[:, 1] = nz.x[:, 2], nz.y[:, 2]
    sw = AffinePoint(*(t.clone() for t in gct.data))
    sw.x[:, 3], sw.y[:, 3], sw.inf[3] = sw.x[:, 4], sw.y[:, 4], sw.inf[4]
    got, t_ver = timed(lambda: gd.check_proof_of_plaintext_knowledge(
        pk, scheme.Ciphertext(sw, False), gd.ProofOfPlaintextKnowledge(
            proof.ct, scheme.Ciphertext(nz, False), dl)))
    if got.tolist() != [False, False, True, False] + [True] * (Bd - 4) \
            or gd.route_counts["fused"] != routes0["fused"] + 1 \
            or gd.route_counts["limb"] != routes0["limb"]:
        raise AssertionError(f"PoK verify: {int(got.sum())} of {Bd} lanes "
                             "true, not every honest lane and no tampered "
                             f"one (DL, nonce, ciphertext); routes "
                             f"{gd.route_counts}")
    log(f"gadgets: {Bd} decryption proofs true, a tampered randomness "
        f"false; {Bd} proofs of plaintext knowledge verified once on the "
        f"fused RNS route (limb fallback 0 times): every honest lane true, "
        f"a tampered DL, nonce and ciphertext false [{card}]")
    part("PoK prove and verify")
    # the device digests against hashlib over serialize.point_bytes
    words, t_fs = timed(lambda: gd._fs_digest(dk, proof.ct.data,
                                              proof.nonce.data))
    hp = convert.affine_to_host(ctx, proof.ct.data)
    hn = convert.affine_to_host(ctx, proof.nonce.data)
    want = [hashlib.sha256(ser.point_bytes(pk, u) + ser.point_bytes(pk, v))
            .digest() for u, v in zip(hp, hn)]
    wnp = words.cpu().numpy()
    if [row.astype(">u4").tobytes() for row in wnp] != want:
        raise AssertionError("device Fiat-Shamir digests != hashlib")
    msg = torch.randint(0, 1 << 32, (Bd, 2 * L), device=dev)
    pad, _ = sha.pad_words(8 * L)
    msg = torch.cat([msg, torch.as_tensor(pad, device=dev).expand(Bd, -1)],
                    dim=1)
    sha.sha256_words(msg)
    _, t_sha = timed(lambda: sha.sha256_words(msg))
    log(f"gadgets: all {Bd} device digests equal hashlib's on "
        f"serialize.point_bytes; _fs_digest {t_fs * 1e3:.1f} ms, "
        f"sha256_words of {Bd} messages of {8 * L} bytes "
        f"{t_sha * 1e3:.1f} ms [{card}]")
    part("digests against hashlib, sha256_words")
    # a small batch with an identity nonce in lane 5, which the RNS
    # route's incomplete addition cannot take: the batch goes to the limb
    # verify at once
    nfb = 8
    nn = AffinePoint(*(t[..., :nfb].clone() for t in proof.nonce.data))
    nn.x[:, 5], nn.y[:, 5], nn.inf[5] = 0, 0, 1
    small = gd.ProofOfPlaintextKnowledge(proof.ct[:nfb],
                                         scheme.Ciphertext(nn, False),
                                         proof.dl[:nfb])
    r0 = dict(gd.route_counts)
    got, t_fb = timed(lambda: gd.check_proof_of_plaintext_knowledge(
        pk, gct[:nfb], small))
    if gd.route_counts != dict(r0, limb=r0["limb"] + 1) \
            or got.tolist() != [True] * 5 + [False] + [True] * (nfb - 6):
        raise AssertionError(f"PoK: the identity nonce did not send the "
                             f"batch to the limb verify or its answers "
                             f"{got.tolist()} are wrong ({gd.route_counts})")
    log(f"gadgets: an identity nonce in lane 5 of {nfb} sent the batch to "
        f"the limb verify ({t_fb:.2f} s), whose answers {got.tolist()} are "
        f"the truth; routes {gd.route_counts} [{card}]")
    part("identity-nonce batch")
    log("4j by part: " + ", ".join(parts) + f" [{card}]")
    for op, t, unit in (("decryption-proof check", t_dpc, "proofs"),
                        ("PoK prove", t_prove, "proofs"),
                        ("PoK verify", t_ver, "proofs"),
                        ("Fiat-Shamir digest (_fs_digest)", t_fs, "digests"),
                        ("sha256_words", t_sha, "digests")):
        log(f"{op} {Bd / t:.1f} {unit}/s (B={Bd}, 512-bit key) [{card}]")
    launches_gadgets = read_counts("gadgets", GADGET_PATH)
    del proof, words, msg, nz, sw, nn, small, pkg
    phase_done("4j (gob, conformance, gadgets)")

    # -- 4k. the parallel layer at world size 1, the cli, the native keygen
    import contextlib
    import io
    import socket
    import tempfile

    import torch.distributed as tdist

    from bgn_torch import cli, parallel
    from bgn_torch.parallel import multihost as mh
    from bgn_torch.parallel import pipeline as pp
    from bgn_torch.parallel import sharded as sh
    from bgn_torch.utils import native, profiling

    parts, part_t = [], [time.time()]      # 4k's seconds by part

    def ct_cat(u, v):
        """Two ciphertext batches of one level side by side."""
        if u.level2:
            return scheme.Ciphertext(torch.cat([u.data, v.data], -1), True)
        return scheme.Ciphertext(AffinePoint(*(
            torch.cat([x, y], -1) for x, y in zip(u.data, v.data))), False)

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        if tdist.get_backend() != "nccl":
            raise AssertionError(f"backend {tdist.get_backend()}, not nccl")
        gmesh = mh.make_global_mesh()
        if mh.process_info() != (0, 1) or gmesh.size() != 1 \
                or BGNParams().make_mesh() is not None:
            raise AssertionError("world size 1: process_info, the global "
                                 "mesh or BGNParams.make_mesh is wrong")
        mesh = parallel.make_mesh(1)
        smesh = parallel.make_mesh(1, pp.STAGE_AXIS)
        log(f"parallel: a {tdist.get_backend()} group of 1 rank on tcp "
            f"127.0.0.1:{port}, "
            f"{gmesh}, {mesh}, {smesh}")
        # one batch per level: phase 4's lanes, then m = 0 and negatives,
        # and (L2) one lane out of range (50 * 50 > bound^2 + bound); the
        # limb route takes phase 4h's key (the same key without its RNS
        # context, whose ciphertexts 4h found bit-equal) on its first Bn
        # lanes and the same extra lanes
        xs = [0, -1, -5, -100, -1000, 7]
        xr = [mrng.randrange(pk.n) for _ in xs]
        e1 = pk.encrypt_with_randomness(xs, xr)
        e2 = pk.mult(pk.encrypt_with_randomness(xs + [50], xr + [3]),
                     pk.encrypt_with_randomness([1] * 6 + [50], xr + [4]))
        batches = {"L1": (ct_cat(a[:Bd], e1), ct_cat(a_h, e1)),
                   "L2": (ct_cat(prod[:Bd], e2), ct_cat(prod_h, e2))}
        fns = {"L1": sh.decrypt_g1_sharded, "L2": sh.decrypt_gt_sharded}
        rep_before = [t.clone() for t in pk.dev.buffers()]
        tpar, got = {}, {}         # label -> (lanes, seconds); results
        part("start-up, extra lanes")
        zero_counts()
        (dp_a, dp_prod), t = timed(lambda: (
            sh.encrypt_sharded(pk, ms[:Bd], mesh, rng=random.Random(41)),
            sh.mult_sharded(pk, a[:Bd], b[:Bd], mesh)))
        tpar["DP Encrypt + Mult"] = (Bd, t)
        replicate_ok = all(torch.equal(x, y) for x, y in zip(
            parallel.replicate(pk.dev, mesh).buffers(), rep_before))
        for lvl, (c_rns, c_limb) in batches.items():
            for route, key, skey, c in (("rns", pk, sk, c_rns),
                                        ("limb", pkn, skn, c_limb)):
                got[route, lvl], t = timed(
                    lambda: fns[lvl](key, skey, tables, c, mesh))
                tpar[f"sharded Decrypt {lvl} ({route} route)"] = (
                    c.batch_shape[0], t)
        part("DP ops, sharded decrypts")
        z_pipe, t = timed(
            lambda: pp.pairing_pipeline(pk.dev, a.data, b.data, smesh, 4))
        tpar["pipelined pairings (S = 1, 4 microbatches)"] = (B, t)
        launches_par = read_counts("parallel", PARALLEL_PATH)
        part("pipeline")

        # the checks, after the count
        if not ct_equal(dp_a, pk.encrypt(ms[:Bd], rng=random.Random(41))) \
                or not ct_equal(dp_prod, prod[:Bd]) or not replicate_ok:
            raise AssertionError("DP Encrypt / Mult / replicate differ from "
                                 "the unsharded ops")
        for lvl, (c_rns, _) in batches.items():
            m2, f2 = sk.decrypt_with_status(c_rns, pk, tables)
            limb_lanes = list(range(Bn)) + list(range(Bd, len(f2)))
            for route, lanes in (("rns", slice(None)), ("limb", limb_lanes)):
                (m1, f1), mw, fw = got[route, lvl], m2[lanes], f2[lanes]
                if list(f1) != list(fw) or list(m1[f1]) != list(mw[fw]):
                    raise AssertionError(f"sharded decrypt {lvl} ({route} "
                                         "route) != decrypt_with_status")
        nf = [int((~got[r, "L2"][1]).sum()) for r in ("rns", "limb")]
        if nf != [1, 1] or not all(got[r, "L1"][1].all()
                                   for r in ("rns", "limb")):
            raise AssertionError(f"lanes not found: {nf} (L2), want 1 each")
        z_ref = rp.pairing_rns(ctx, rns, a.data, b.data, dk.n_bits,
                               dk.l_bits)
        if not torch.equal(z_pipe, z_ref):
            raise AssertionError("pairing_pipeline != pairing_rns")
        decrypt_all(sk, pk, tables, scheme.Ciphertext(z_pipe, True),
                    [m * kk for m, kk in zip(ms, ks)], "pipeline (m*k)", Bd)
        log(f"parallel: DP Encrypt and Mult equal the unsharded ops on {Bd} "
            f"lanes, replicate(pk.dev) left every buffer equal; the sharded "
            f"decrypts, RNS route ({Bd} + {len(xs)} L1, {Bd} + "
            f"{len(xs) + 1} L2 lanes) and limb route (phase 4h's key, "
            f"{Bn} + {len(xs)} L1, {Bn} + {len(xs) + 1} L2 lanes), equal "
            "decrypt_with_status, the one L2 lane out of range not found; "
            "the pipeline (S = 1, 4 microbatches) equals pairing_rns on all "
            f"{B} lanes")
        for what, (n, t) in tpar.items():
            log(f"{what}: {n / t:.1f} ops/s first call (B={n}, {t:.3f} s) "
                f"[{card}]")
        part("checks")
        t_gt = profiling.time_op(sh.decrypt_gt_sharded, pk, sk, tables,
                                 prod[:Bd], mesh, iters=1, warmup=0)
        log(f"profiling.time_op: decrypt_gt_sharded {t_gt * 1e3:.1f} ms "
            f"(B={Bd}) [{card}]")
        mb_ = B // 4
        with tempfile.TemporaryDirectory() as tdir:
            with profiling.trace(tdir):
                pp.pairing_pipeline(pk.dev, a[:mb_].data, b[:mb_].data,
                                    smesh, 1)
            text = "".join(Path(f).read_text()
                           for f in Path(tdir).glob("trace_*.json"))
        if "bgn_dbl_step" not in text:
            raise AssertionError("the pipeline's trace names no dbl_step "
                                 "kernel")
        log(f"profiling.trace: one microbatch ({mb_} lanes), "
            f"{len(text)} bytes of Chrome trace naming bgn_dbl_step")
        part("profiling")
    finally:
        tdist.destroy_process_group()
    del pkn, skn, a_h, prod_h, e1, e2, batches, got, z_pipe, z_ref
    del dp_a, dp_prod

    # the demo checks of cli.py on the card (two 512-bit keys)
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        simple = cli.run_simple_check(512, 3, seed=1, device="cuda")
        poly = cli.run_poly_arithmetic_check(512, 1021, 3, 3, 0.0001, seed=1,
                                             device="cuda")
    text = out.getvalue()
    lines = re.findall(r"^([-()01 +*]+) = (-?\d+)$", text, re.M)
    if len(lines) != 18 or any(
            int(v) != eval(e, {"__builtins__": {}}) for e, v in lines) \
            or any(r[1] != r[2] for r in simple):
        raise AssertionError(f"cli truth table wrong:\n{text}")
    for label, want, val in poly:
        if abs(val - float(want)) > 1e-3 * abs(float(want)) \
                or f"E({val})" not in text:
            raise AssertionError(f"cli poly {label}: {val} against {want}")
    log(f"cli: the truth table (18 lines) exact and the {len(poly)} poly "
        f"values within 1e-3 of the plaintexts' arithmetic, "
        f"{time.time() - t0:.1f} s with two 512-bit keygens [{card}]")
    part("cli")

    # the native host-math library
    t0 = time.time()
    l_nat = native.find_cofactor(pk.n)
    t_nat = time.time() - t0
    t0 = time.time()
    l_plain = hm.find_cofactor_plain(pk.n)
    t_plain = time.time() - t0
    if l_nat != l_plain or l_nat != pk.l:
        raise AssertionError(f"find_cofactor {l_nat} != plain {l_plain}")
    log(f"native: find_cofactor(n) of phase 2's key = {l_nat}, "
        f"{t_nat * 1e3:.1f} ms against the plain loop's {t_plain * 1e3:.1f} "
        "ms; host keygen seconds: "
        + ", ".join(f"{kb} {t:.1f}" for kb, t in t_keys.items())
        + f" [{card}]")
    part("native")
    log("4k by part: " + ", ".join(parts) + f" [{card}]")
    phase_done("4k (parallel, cli, native keygen)")

    # -- 5. where the time goes: one profiled call of each op ------------
    for label, fn in (("Encrypt", lambda: pk.encrypt_with_randomness(ms, rs)),
                      ("Mult", lambda: pk.mult(a, b)),
                      ("step-mode Encrypt", lambda: in_step_mode(
                          lambda: pk.encrypt_with_randomness(ms, rs))),
                      ("step-mode Mult", lambda: in_step_mode(
                          lambda: pk.mult(a, b))),
                      ("limb-mode Encrypt", lambda: in_limb_mode(
                          lambda: pk.encrypt_with_randomness(ms, rs))),
                      ("limb-mode Mult", lambda: in_limb_mode(
                          lambda: pk.mult(a, b))),
                      ("DecryptL2", lambda: sk.decrypt(prod[:Bd], pk, tables)),
                      ("Add", lambda: pk.add(a, b)),
                      ("Decrypt (L1)", lambda: sk.decrypt(ct1[:Bd], pk,
                                                          tables)),
                      ("step-mode Decrypt (L1)", lambda: in_step_mode(
                          lambda: sk.decrypt(ct1[:Bd], pk, tables))),
                      ("step-mode DecryptL2", lambda: in_step_mode(
                          lambda: sk.decrypt(prod[:Bd], pk, tables))),
                      ("Mult (re-randomized)",
                       lambda: pkr.mult(ar, br, rng=random.Random(13))),
                      ("L2 Add (re-randomized)",
                       lambda: pkr.add(prodr, prod2r, rng=random.Random(15)))):
        wall, busy, by_name = profile_op(torch, label, fn, card, wrappers)
        if label == "limb-mode Mult":
            digit_ms = sum(ms for nm, (ms, _) in by_name.items()
                           if "_digits_" in nm)
            log(f"  limb-mode Mult: the digit steps {digit_ms:.1f} ms of "
                f"{busy:.1f} ms busy ({100 * digit_ms / busy:.1f} %), idle "
                f"share {1 - busy / wall:.3f} [{card}]")
    # the poly path and the models: the kernels beside the torch-op glue
    # (the GT accumulation, with its skew gather, profiled alone on a
    # [2, L, d*d, B] batch of GT values of MultPoly's shape)
    d = Xs.degree
    prods_like = M.ct.data[:, :, :d].repeat(1, 1, d, 1).contiguous()
    prof = {}
    for label, fn in (
            (f"MultPoly (B={Bp}, 100.1)", lambda: pc.mult_poly(pkp, Xs, Xs)),
            ("MultPoly's GT accumulation (skew gather + fold)",
             lambda: pc._poly_accumulate_l2(pkp.dev, prods_like, d, d)),
            (f"encrypted_dot (D={D}, B={Bm})",
             lambda: edot.encrypted_dot(pkp, xd, yd))):
        wall, busy, by_name = profile_op(torch, label, fn, card, wrappers)
        k_ms = sum(ms for nm, (ms, _) in by_name.items() if "bgn_" in nm)
        k_n = sum(n for nm, (_, n) in by_name.items() if "bgn_" in nm)
        n_all = sum(n for _, n in by_name.values())
        prof[label] = (busy, n_all)
        log(f"  {label}: {k_n} kernel launches {k_ms:.1f} ms "
            f"({100 * k_ms / max(busy, 1e-9):.1f} % of busy), glue "
            f"{n_all - k_n} device ops {busy - k_ms:.1f} ms; wall "
            f"{wall:.1f} ms [{card}]")
    (mb, mn), (ab, an) = list(prof.values())[:2]
    log(f"  MultPoly: its GT accumulation is {an} of {mn} device ops "
        f"({100 * an / mn:.1f} %) and {ab:.1f} of {mb:.1f} ms busy "
        f"({100 * ab / mb:.1f} %) [{card}]")
    # host time per step launch at N = 1 (what a lone chain of the
    # per-step configuration, as step-mode Encrypt's inversions, waits on)
    o = [rns.one_rns.expand(2 * k, 1).contiguous() for _ in range(9)]
    for name, fn in (
            ("dbl_step", lambda: cuda_rns.dbl_step(rns, *o[:7])),
            ("pow_step", lambda: cuda_rns.pow_step(rns, o[0], o[1], 1)),
            ("add_step", lambda: cuda_rns.add_step(rns, *o)),
            ("pt_dbl", lambda: cuda_rns.pt_dbl(rns, *o[:3])),
            ("pt_add", lambda: cuda_rns.pt_add(rns, *o[:5])),
            ("fp2_pow_step", lambda: cuda_rns.fp2_pow_step(rns, *o[:4],
                                                           1))):
        log(f"host time per {name} launch (N = 1): "
            f"{host_us(fn, torch):.2f} us [{card}]")
    phase_done("5 (profile)")

    kernels = []
    for name in REPLACES:
        recs = results[name]
        main = recs[0]
        if name in STEP_PATH:          # the per-step configuration
            launches = launches_step[name] + launches_par[name]
            paths = ("step", "parallel")
        elif name in digit_names:      # the limb-domain configuration
            launches = launches_digit[name]
            paths = ("limb-domain",)
        else:
            launches = (launches_main[name] + launches_l1[name]
                        + launches_limb[name] + launches_poly[name]
                        + launches_gadgets[name] + launches_par[name])
            paths = ("main", "L1", "limb", "poly", "gadgets", "parallel")
        splits = {}
        for path in paths:
            for split, counts_by in splits_of[path][name].items():
                into = splits.setdefault(split, {})
                for key, c in counts_by.items():
                    into[key] = into.get(key, 0) + c
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bgn_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches,
            "launches_by_path": {"main": launches_main[name],
                                 "l1": launches_l1[name],
                                 "limb": launches_limb[name],
                                 "1024": launches_1024[name],
                                 "2048": launches_2048[name],
                                 "step": launches_step[name],
                                 "limb_domain": launches_digit[name],
                                 "no_rns": launches_norns[name],
                                 "poly": launches_poly[name],
                                 "gadgets": launches_gadgets[name],
                                 "parallel": launches_par[name]},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "match": True, "shape": main["shape"],
            "key_bits": main["key_bits"], "other_shapes": recs[1:]})
        if name in imma:
            kernels[-1]["sass_imma"] = imma[name]
        for split, counts_by in splits.items():
            kernels[-1][split] = dict(sorted(counts_by.items()))
        kernels[-1]["ptxas"] = [
            r for r in ptxas if r["kernel"] == name
            or (name == "mont_mul" and r["kernel"].startswith("mont_"))
            or (name in digit_names and r["kernel"] == name + "_loop")]
        if name == "mont_mul":
            kernels.append(dict(kernels[-1], name=MONT_U32[0],
                                replaces=MONT_U32[1]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
