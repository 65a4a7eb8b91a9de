"""Build and bind the CUDA kernels of `bgn_torch/csrc/`.

At first use, `library()` compiles every `csrc/*.cu` with nvcc for
sm_90a (one nvcc per source, all started together), links them into one
shared library with a plain C interface, and loads it with ctypes.  The
library lives in `build/kernels/` at the root of the checkout and is
rebuilt when a source is newer than it.  Nothing here runs at import.
`launch` calls an entry on the current stream for the wrappers of
ops/cuda_rns.py, ops/cuda_pairing.py and fieldcore/cuda_mont.py.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c <src>.cu
    nvcc -shared -o libbgn_rns.so *.o
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libbgn_rns.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry -> argument types, the stream last; the RNS kernels, every one
# on the tensor-core product, take (blob, planes, k, slots, ...) first;
# bgn_mont_mul_loop is mont_mul's local-memory loop at any L (chip_smoke.py
# times it beside the register kernels)
_SIGNATURES = {
    "bgn_mont_mul": [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _P, _I, _P],
    "bgn_mont_mul_loop": [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _P, _I, _P],
    "bgn_miller_loop": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                        _P],
    "bgn_pow_loop": [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P],
    "bgn_fp2_pow_loop": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P],
    "bgn_dual_ladder": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                        _P, _P, _P, _P, _I, _P],
    "bgn_ladder_loop": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                        _P, _P, _I, _P],
    "bgn_window_ladder_tab": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                              _P, _I, _P],
    "bgn_window_ladder": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                          _P],
    "bgn_dbl_step": [_P, _P, _I, _I] + [_P] * 12 + [_I, _P],
    "bgn_add_step": [_P, _P, _I, _I] + [_P] * 14 + [_I, _P],
    "bgn_pt_dbl": [_P, _P, _I, _I] + [_P] * 6 + [_I, _P],
    "bgn_pt_add": [_P, _P, _I, _I] + [_P] * 8 + [_I, _P],
    "bgn_pow_step": [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P],
    "bgn_fp2_pow_step": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                         _P],
    # the exit conversion: (..., exit blob, L, x0, x1, out, n, halves)
    "bgn_rns_exit": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    # the digit-domain Miller steps: (inputs, outputs, p, L, n)
    "bgn_miller_dbl_digits": [_P] * 13 + [_I, _I, _P],
    "bgn_miller_add_digits": [_P] * 15 + [_I, _I, _P],
    # no launch: the Miller kernel's shared memory per block at (k, slots)
    "bgn_miller_loop_smem": [_I, _I],
}

# what the last build did: seconds, and nvcc's -Xptxas -v report
BUILD_INFO = {"seconds": None, "ptxas": "", "rebuilt": False}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _stale(lib: Path, sources) -> bool:
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    return any(s.stat().st_mtime > t for s in sources)


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into build/kernels/libbgn_rns.so if stale."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    if not force and not _stale(lib, sources + headers):
        BUILD_INFO.update(seconds=0.0, rebuilt=False)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        reports.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(reports))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("link failed\n" + link.stdout)
    tmp.replace(lib)
    BUILD_INFO.update(seconds=time.time() - t0, ptxas="\n".join(reports),
                      rebuilt=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if stale)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bgn_error_string.argtypes = [ctypes.c_int]
    lib.bgn_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return library().bgn_error_string(err).decode()


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer as a C pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def launch(entry: str, *args) -> None:
    """Call a C entry of the kernel library on the current stream; raise
    on a nonzero cudaGetLastError()."""
    import torch
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({error_string(err)})")


def is_cpu(t) -> bool:
    """True for a CPU tensor (a wrapper then runs its plain version), False
    for a CUDA tensor; any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False
