"""bgn_torch: the BGN (Boneh-Goh-Nissim) somewhat-homomorphic encryption
scheme on PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

The port of `bgn_tpu` (JAX/Pallas), which stays in the repository as the
reference.  This package imports neither JAX nor `bgn_tpu`.  Entry points
run on the card (device="cuda") unless the caller passes device="cpu",
where every kernel wrapper runs its plain PyTorch version.

    import random
    from bgn_torch import scheme
    pk, sk = scheme.keygen(512, 1021, rng=random.Random(1))
    tables = pk.setup_decryption(sk, rng=random.Random(2))
    prod = pk.mult(pk.encrypt([3, 4]), pk.encrypt([5, 6]))
    sk.decrypt(prod, pk, tables)             # -> [15, 24]
"""

from .ops import cuda_rns  # noqa: F401  (sets and asserts TF32 off)
from .scheme import keygen  # noqa: F401
