"""Multi-chip parallelism: device meshes, sharded lifecycle, collectives.

The reference is single-threaded CPython (SURVEY.md §2: no parallelism of any
kind); this subsystem is new, designed per SURVEY.md §2's parallelism
table:

* **dp** ("keys"): the batch of one-time keys/signatures sharded across chips;
* **tp** ("rank"): the rank axis of sk/sig tensors sharded, with A·x and the
  verify target reduced by ``psum`` over the rank axis;
* **sp** (coefficients): NTT butterfly stages exchanged via ``all_to_all``
  (distributed four-step NTT) when coefficient blocks are sharded;
* aggregation: per-shard partial weighted sums + ``psum`` over the batch axis.

The communication backend is XLA's collective runtime over ICI/DCN — there is
no NCCL/MPI analogue to port.
"""
from .mesh import make_mesh
from .sharded import prepare_real, sharded_lifecycle_step
