"""ctypes binding of the native host-math library: Miller-Rabin and the A1
cofactor search with an incremental small-prime sieve (the role PBC's C
parameter generator plays for the reference, bgn.go:93).  The port's
counterpart of `bgn_tpu/utils/native.py`.

The port builds its own copy of the library from the repo's
csrc/hostmath_accel.cpp, with g++ into build/host/ at the first use (a
file lock, then a temporary file per process and an atomic rename, so
that parallel processes build it once and never load a half-written
file).  A failed build raises with the compiler's output; nothing falls
back to the Python loops then.  csrc/ is only read.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "hostmath_accel.cpp"
BUILD_DIR = _ROOT / "build" / "host"
LIB_NAME = "libbgnhost.so"
# the widest inputs of the library (csrc: MAX_LIMBS = 72 64-bit words; the
# cofactor search keeps two words for l*n)
PRIME_MAX_BYTES = 72 * 8
COFACTOR_MAX_BYTES = 70 * 8
# the cofactor search screens p = l*n - 1 by the primes up to 100000 and
# takes a divisible p as composite, which holds only for p above them
_SIEVE_MAX = 100000


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library into build_dir unless it is newer than the
    source; raises RuntimeError with g++'s output on failure."""
    lib = build_dir / LIB_NAME
    if lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime:
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / (LIB_NAME + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime:
            return lib              # another process built it meanwhile
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native host-math "
                               "library builds with g++")
        tmp = build_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        run = subprocess.run(
            [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if run.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {source}:\n{run.stdout}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first if stale)."""
    lib = ctypes.CDLL(str(build()))
    lib.bgn_is_probable_prime.restype = ctypes.c_int
    lib.bgn_is_probable_prime.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int]
    lib.bgn_find_cofactor.restype = ctypes.c_ulonglong
    lib.bgn_find_cofactor.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_ulonglong, ctypes.c_ulonglong,
                                      ctypes.c_int]
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return library() is not None


def _bytes(n: int) -> bytes:
    return n.to_bytes(max((n.bit_length() + 7) // 8, 1), "little")


def is_probable_prime(n: int, rounds: int = 40) -> Optional[bool]:
    """Native Miller-Rabin of n >= 0, or None for an n wider than the
    library takes (a size route: the caller runs the Python loop)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    le = _bytes(n)
    if len(le) > PRIME_MAX_BYTES:
        return None
    r = library().bgn_is_probable_prime(le, len(le), rounds)
    if r < 0:
        raise RuntimeError(f"bgn_is_probable_prime refused {len(le)} bytes")
    return bool(r)


def find_cofactor(n: int, start_l: int = 4, max_l: int = 1 << 40,
                  rounds: int = 40) -> Optional[int]:
    """Native A1 cofactor search: the smallest l = start_l + 4k <= max_l
    with l*n - 1 prime.  None for an n outside the library's sizes (a size
    route: the caller runs the Python loop): wider than it takes, or so
    small that its sieve would reject a prime p = l*n - 1 <= 100000."""
    if n <= 0:
        raise ValueError("n must be > 0")
    le = _bytes(n)
    if len(le) > COFACTOR_MAX_BYTES or start_l * n - 1 <= _SIEVE_MAX:
        return None
    l = library().bgn_find_cofactor(le, len(le), start_l, max_l, rounds)
    if not l:
        raise RuntimeError(f"no cofactor l <= {max_l} for n = {n}")
    return int(l)
