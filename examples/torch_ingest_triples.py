"""The data-layer contract on the PyTorch port, end to end on a toy
dataset (the counterpart of examples/ingest_triples.py):

    triples -> vocab/COO -> manifest -> balanced BCSR shards -> sweep

Writes a small TSV triple list, ingests it without ever materializing the
dense tensor, partitions it onto a 2x2 grid with nnzb balancing, prints
the manifest (logical vs resident bytes), and runs model selection on the
block-sparse operand (its shards merged into one BCSR on one device).

    PYTHONPATH=src python examples/torch_ingest_triples.py --device cpu

Runs on the GPU by default, the MU products on the BCSR CUDA kernels.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.io import ingest_tsv, manifest_of, partition_coo
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.selection import RescalkConfig, SweepScheduler


def write_toy_triples(path: str, n=48, m=2, k_true=3, nnz=1500, seed=0):
    """Community-structured triples: entities in the same bloc interact
    more (and more strongly): the planted structure the sweep should
    recover."""
    rng = np.random.default_rng(seed)
    bloc = rng.integers(0, k_true, n)
    with open(path, "w") as f:
        f.write("# toy knowledge graph: head \\t relation \\t tail \\t w\n")
        written = 0
        while written < nnz:
            a, b = rng.integers(0, n, 2)
            same = bloc[a] == bloc[b]
            if not same and rng.random() > 0.04:
                continue                       # inter-bloc edges are rare
            r = rng.integers(0, m)
            w = rng.random() + (2.0 if same else 0.05)
            f.write(f"ent{a}\trel{r}\tent{b}\t{w:.3f}\n")
            written += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "toy.tsv")
        write_toy_triples(path)

        # 1. chunked ingest: vocab + streaming COO (O(nnz) memory)
        coo, vocab = ingest_tsv(path)
        print(f"ingested {coo.nnz} unique triples, "
              f"{vocab.n} entities, {vocab.m} relations")

        # 2. balanced BCSR shards on a 2x2 grid, built on the device
        sharded = partition_coo(coo, bs=32, grid=2, device=args.device)
        print(f"partition: {np.asarray(sharded.nnzb).tolist()} stored "
              f"blocks per shard, balance {sharded.balance:.2f}x of ideal")

        # 3. the manifest is the dataset's identity: the sweep scheduler
        #    embeds it in its checkpoint guard
        man = manifest_of(sharded)
        print(f"manifest: {man.kind}, logical "
              f"{man.logical_bytes / 2**20:.2f} MiB -> resident "
              f"{man.resident_bytes / 2**20:.2f} MiB "
              f"({man.compression:.1f}x)")

        # 4. model selection on the block-sparse operand (stored-block
        #    perturbation, paper §4.2)
        cfg = RescalkConfig(k_min=2, k_max=4, n_perturbations=4,
                            rescal_iters=200, regress_iters=40,
                            kernel=KernelPolicy(use_fused=True))
        res = SweepScheduler(cfg).run(sharded)
        print()
        print(res.summary())
        print(f"\nselected k_opt = {res.k_opt} (planted 3)")

        # factors live in the partition's permuted space; translate back
        A = sharded.part.unpermute_factor(res.per_k[res.k_opt].A_median)
        print(f"median factor in original entity order: {A.shape}")
        return res.k_opt


if __name__ == "__main__":
    main()
