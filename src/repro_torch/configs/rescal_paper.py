"""The paper's own workload configs, distributed non-negative RESCAL (port
of ``repro/configs/rescal_paper.py``: the same three cells, field for
field).

  rescal-small      the correctness / model-selection tier (paper §6.2's
                    synthetic battery scale), CPU-sized.
  rescal-dense-3tb  §6.5's "model determination in large data": a dense
                    20 x 196608^2 fp32 tensor (3.09 TB), k = 10.
  rescal-sparse-eb  §6.5's exabyte-sparse analogue at the paper's sparse
                    n = 373,555,200, BCSR-blocked (128^2 blocks, block
                    density 2.0e-7), k = 10, the per-slice schedule.

The cells and their sizes are ``repro``'s, chosen there for its own
target.  What one rank of the production grid holds of each on the
card, and whether that fits the card's memory, is the dry run's plan
(``launch/dryrun.py``), and the numbers it gives are the port's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RescalConfig:
    name: str
    n: int                      # entities
    m: int                      # relations
    k: int                      # decomposition rank (or k_max for RESCALk)
    dtype: str = "float32"
    sparse: bool = False
    block_size: int = 128       # BCSR tile
    block_density: float = 1.0  # stored-block fraction (sparse only)
    k_min: int = 2              # model-selection sweep bounds
    k_max: int = 10
    n_perturbations: int = 10
    schedule: str = "batched"   # "batched" | "sliced" (paper Alg. 3)
    family: str = "rescal"

    @property
    def dense_bytes(self) -> int:
        return self.m * self.n * self.n * 4

    @property
    def stored_bytes(self) -> int:
        if not self.sparse:
            return self.dense_bytes
        nb = self.n // self.block_size
        nnzb = int(nb * nb * self.block_density)
        return self.m * nnzb * self.block_size * self.block_size * 4


RESCAL_SMALL = RescalConfig(name="rescal-small", n=1024, m=8, k=8,
                            k_min=2, k_max=8)

RESCAL_DENSE_3TB = RescalConfig(name="rescal-dense-3tb", n=196608, m=20,
                                k=10)

RESCAL_SPARSE_EB = RescalConfig(name="rescal-sparse-eb", n=373555200, m=20,
                                k=10, sparse=True, block_density=2.0e-7,
                                schedule="sliced")

RESCAL_CONFIGS = {c.name: c for c in
                  (RESCAL_SMALL, RESCAL_DENSE_3TB, RESCAL_SPARSE_EB)}
