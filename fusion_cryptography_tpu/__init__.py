"""fusion_cryptography_tpu — a JAX-native Fusion aggregate-signature framework.

A from-scratch JAX/XLA re-architecture of the Fusion one-time aggregatable
post-quantum lattice signature scheme (reference: geometry-labs/fusion-cryptography;
paper eprint.iacr.org/2023/303).  Two API levels:

* **Tensor-native batched API** (`fusion_cryptography_tpu.scheme`): dense
  int32 coefficient tensors, jitted device kernels, mesh sharding — the
  production path.
* **Object compat API** (`fusion_cryptography_tpu.interop.api` and
  `.interop.objects`): the reference's class-per-polynomial surface with
  bit-identical serialization, for drop-in use and KAT parity.

All outputs are bit-exact against the reference KAT corpus for both
secpar=128 and secpar=256.
"""
from .params import Params, fusion_setup, PRIME
from .scheme import (
    KeyBatch,
    SignatureBatch,
    keygen,
    sign,
    aggregate,
    verify,
    verify_batch,
    verify_many,
)

__version__ = "0.1.0"

__all__ = [
    "Params",
    "fusion_setup",
    "PRIME",
    "KeyBatch",
    "SignatureBatch",
    "keygen",
    "sign",
    "aggregate",
    "verify",
    "verify_batch",
    "verify_many",
    "__version__",
]
