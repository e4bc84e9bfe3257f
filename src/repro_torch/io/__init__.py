"""Data ingest of the port: TSV or NPZ triples to a BCSR tensor, and the
manifest of a BCSR or dense operand."""
from .manifest import DatasetManifest, manifest_of, operand_dims
from .partition import coo_to_bcsr
from .triples import (COOTensor, Vocab, ingest_npz, ingest_tsv, read_coo_npz,
                      read_triples_tsv)

__all__ = ["COOTensor", "DatasetManifest", "Vocab", "coo_to_bcsr",
           "ingest_npz", "ingest_tsv", "manifest_of", "operand_dims",
           "read_coo_npz", "read_triples_tsv"]
