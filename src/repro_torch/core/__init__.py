"""RESCAL core of the port: MU updates, BCSR tensors, the per-k
reduction's clustering, silhouettes and regression."""
