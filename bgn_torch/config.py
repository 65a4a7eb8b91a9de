"""One dataclass for the scheme and kernel knobs: the port's counterpart of
`bgn_tpu/config.py` (`BGNParams`, the JAX package's primary interface).

The fields, defaults, validation and (de)serialization are the JAX
package's, so a `BGNParams.to_dict()` written by either package loads in
the other.  Unlike the JAX package, the port reads no environment
variable: `apply_kernel_modes` is the only way to change a kernel mode.

Usage:
    params = BGNParams(key_bits=512, msg_space=1021, rns_pallas="1")
    pk, sk = params.keygen(rng)        # applies the kernel modes first

Kernel modes the port runs (each field's None keeps the default):
  rns_pallas   "loop" (the default: each ladder, Miller loop, window
               chain and exponentiation as one kernel) or "1" (one kernel
               launch per step: ops/rns_pairing.py).
  rns_miller   "auto" or "1" (the default: the RNS field path on every
               device; the JAX package's "auto" is RNS on a TPU only) or
               "0": the limb-domain configuration, every op on limbs
               (ops/pairing.py use_rns).
  fused_miller True (the default) or False: under rns_miller="0", the
               Miller loop through the digit-domain step kernels
               (ops/cuda_pairing.py) while 2L + 1 <= 129, or always the
               limb Miller loop through mont_mul.
  pallas       True: the limb product as its CUDA kernel, the port's only
               form.
Every other value raises, for the reason given in ROADMAP.md (queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# rns_pallas values of the JAX package that the port refuses, and why
_INTERPRET = ("a JAX interpreter mode; the port's counterpart is "
              "device=\"cpu\", where every wrapper runs its plain version")
_REFUSED_RNS_PALLAS = {
    "0": "the pure-XLA steps would be the plain PyTorch versions on CUDA "
         "tensors, which the port never runs there",
    "interpret": _INTERPRET,
    "loop-interpret": _INTERPRET,
}


@dataclasses.dataclass
class BGNParams:
    """Everything configurable, in one place.

    Scheme fields mirror NewKeyGen(keyBits, msgSpace, polyBase,
    fpScaleBase, fpPrecision, deterministic) (reference bgn.go:65) and
    default to the reference's test constants (bgn_test.go:8-13)."""

    # -- scheme (reference NewKeyGen args + PolyEncodingParams) ----------
    key_bits: int = 512
    msg_space: int = 1021
    poly_base: int = 3
    fp_scale_base: int = 3
    fp_precision: float = 0.0001
    deterministic: bool = True

    # -- mesh / sharding (ranks of the default process group) ----------
    n_devices: Optional[int] = None
    mesh_axis: str = "data"

    # -- kernel-mode knobs (None = library default) ----------------------
    rns_miller: Optional[str] = None    # "auto" | "1" | "0"
    rns_pallas: Optional[str] = None    # "loop" | "1"
    fused_miller: Optional[bool] = None  # digit-domain Miller steps
    pallas: Optional[bool] = None        # the limb product's kernel

    def __post_init__(self):
        if self.key_bits < 16 or self.key_bits % 2:
            raise ValueError("key_bits must be an even int >= 16")
        if self.msg_space < 2:
            raise ValueError("msg_space must be >= 2")

    # -- construction -----------------------------------------------------

    def keygen(self, rng=None, device="cuda"):
        """Generate a key pair under this configuration on `device`
        (applies the kernel-mode knobs first)."""
        from . import scheme
        self.apply_kernel_modes()
        return scheme.keygen(self.key_bits, self.msg_space, self.poly_base,
                             self.fp_scale_base, self.fp_precision,
                             self.deterministic, rng=rng, device=device)

    def make_mesh(self):
        """1-D DeviceMesh over the first n_devices ranks of the default
        process group (parallel.make_mesh), or None when fewer than 2 are
        in scope: n_devices if set, else the group's world size (1 without
        a group).  Raises when n_devices asks for more ranks than the group
        has; it never takes fewer."""
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        n = world if self.n_devices is None else int(self.n_devices)
        if n < 2:
            return None
        if n > world:
            raise ValueError(f"n_devices={n}, but the default process group "
                             f"has {world} rank(s): start one of {n} with "
                             "parallel.multihost.initialize")
        from .parallel import make_mesh
        return make_mesh(n, self.mesh_axis)

    def apply_kernel_modes(self) -> None:
        """Check every kernel-mode field, then set the port's kernel
        granularity (rns_pallas), field domain (rns_miller) and Miller
        form (fused_miller); unset fields leave the modes as they are."""
        if self.rns_pallas is not None and self.rns_pallas not in ("loop",
                                                                   "1"):
            why = _REFUSED_RNS_PALLAS.get(
                self.rns_pallas, "unknown value (\"loop\" or \"1\")")
            raise ValueError(f"rns_pallas={self.rns_pallas!r}: {why}")
        if self.rns_miller not in (None, "auto", "1", "0"):
            raise ValueError(f"rns_miller={self.rns_miller!r}: unknown "
                             "value (\"auto\", \"1\" or \"0\")")
        if self.pallas is False:
            raise NotImplementedError(
                "pallas=False: the XLA limb product would be the plain "
                "PyTorch version on CUDA tensors, as rns_pallas='0' would; "
                "not ported (ROADMAP.md queue 3)")
        from .ops import pairing
        from .ops import rns_pairing as rp
        if self.rns_pallas is not None:
            rp._PALLAS_MODE = self.rns_pallas
        if self.rns_miller is not None:
            pairing._RNS_MODE = self.rns_miller
        if self.fused_miller is not None:
            pairing._USE_FUSED = bool(self.fused_miller)

    # -- (de)serialization ------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BGNParams":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown BGNParams fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def reference_test_config(cls) -> "BGNParams":
        """The reference's shared test constants (bgn_test.go:8-13)."""
        return cls(key_bits=512, msg_space=1021, poly_base=3,
                   fp_scale_base=3, fp_precision=0.0001,
                   deterministic=True)
