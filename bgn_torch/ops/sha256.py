"""Batched SHA-256 in torch ops.

The port's counterpart of `bgn_tpu/ops/sha256.py`.  The Fiat-Shamir
transform of the proof of plaintext knowledge hashes the canonical bytes
of every (ct, nonce) pair (gadgets.go:80-96); hashing where the points
live reads back only the 32-byte digests.

Standard FIPS 180-4 SHA-256, vectorized over the batch: every lane's
message has the same static length, so padding is static.  Words are
int64 tensors holding 32-bit values (this torch has no uint32 add, shift
or compare on the CPU): every sum and every rotation is masked back to 32
bits.  The 48 schedule steps and 64 rounds per block are a Python loop
over [B] tensors.  Byte for byte equal to hashlib.sha256
(tests/test_torch_gadgets.py).
"""

from __future__ import annotations

import numpy as np
import torch

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

_MASK = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _MASK


def sha256_words(msg_words: torch.Tensor) -> torch.Tensor:
    """SHA-256 over a batch of equal-length messages.

    msg_words: [B, W] big-endian message words (values < 2^32, any
    integer dtype), W a multiple of 16 (the message must already carry
    FIPS padding -- use pad_words).  Returns [B, 8] int64 big-endian
    digest words on the same device."""
    B, W = msg_words.shape
    if W % 16:
        raise ValueError("message words must be a multiple of 16")
    msg = msg_words.to(torch.int64) & _MASK
    hs = [torch.full((B,), v, dtype=torch.int64, device=msg.device)
          for v in _H0]
    for blk in range(W // 16):
        w = list(msg[:, blk * 16:(blk + 1) * 16].T)
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) \
                ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
        a, b, c, d, e, f, g, h = hs
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)      # ~e's high bits die in & g
            t1 = h + S1 + ch + _K[t] + w[t]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, d, e, f, g, h = ((t1 + S0 + maj) & _MASK, a, b, c,
                                      (d + t1) & _MASK, e, f, g)
        hs = [(x + y) & _MASK for x, y in zip(hs, (a, b, c, d, e, f, g, h))]
    return torch.stack(hs, dim=1)


def pad_words(nbytes: int):
    """Static FIPS padding for an nbytes message (nbytes % 4 == 0):
    returns (pad_words int64 [P], total_words) to append so the padded
    length is a multiple of 64 bytes."""
    if nbytes % 4:
        raise ValueError("message length must be word-aligned")
    total = ((nbytes + 8) // 64 + 1) * 64
    nzero_words = (total - nbytes - 4 - 8) // 4
    pad = [0x80000000] + [0] * nzero_words
    bits = nbytes * 8
    pad += [(bits >> 32) & _MASK, bits & _MASK]
    return np.asarray(pad, dtype=np.int64), total // 4
