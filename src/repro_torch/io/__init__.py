"""Data ingest of the port (port of ``repro/io``): TSV or NPZ triples to a
COO tensor (``triples``), to one BCSR or to balanced shards on the (g, g)
grid (``partition``), virtual datasets generated shard by shard
(``virtual``), and the manifest of every operand (``manifest``).  Nothing
here imports ``repro_torch.selection``."""
from .manifest import DatasetManifest, manifest_of, operand_dims
from .partition import (BlockPartition, CellShard, ShardedBCSR,
                        balanced_partition, coo_to_bcsr, identity_partition,
                        partition_coo, partition_dense)
from .triples import (COOBuilder, COOTensor, Vocab, ingest_npz, ingest_tsv,
                      read_coo_npz, read_triples_tsv)
from .virtual import (ArraySource, SeededSource, VirtualSpec,
                      virtual_bcsr_shard, virtual_dense_full,
                      virtual_dense_shard, virtual_shard_nnzb,
                      virtual_sharded_bcsr)

__all__ = [
    "DatasetManifest", "manifest_of", "operand_dims",
    "BlockPartition", "CellShard", "ShardedBCSR", "balanced_partition",
    "coo_to_bcsr", "identity_partition", "partition_coo", "partition_dense",
    "COOBuilder", "COOTensor", "Vocab", "ingest_npz", "ingest_tsv",
    "read_coo_npz", "read_triples_tsv",
    "ArraySource", "SeededSource", "VirtualSpec", "virtual_bcsr_shard",
    "virtual_dense_full", "virtual_dense_shard", "virtual_shard_nnzb",
    "virtual_sharded_bcsr",
]
