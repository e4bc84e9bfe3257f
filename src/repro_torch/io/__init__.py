"""Data ingest of the port: NPZ COO triples to a BCSR tensor."""
from .partition import coo_to_bcsr
from .triples import COOTensor, ingest_npz, read_coo_npz

__all__ = ["COOTensor", "coo_to_bcsr", "ingest_npz", "read_coo_npz"]
