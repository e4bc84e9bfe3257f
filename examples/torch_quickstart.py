"""Quickstart of the PyTorch port: non-negative RESCAL with automatic
model selection on a synthetic knowledge-graph tensor (the counterpart
of examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on the GPU by default; there the MU products run on the fused
CUDA kernels (fused_xa_xtb, mu_update_a).  The draws are the port's own
(torch generators), so the numbers differ from the JAX example's.
"""
import argparse

import torch

from repro_torch.core.rescal import rescal
from repro_torch.core.rescalk import rescalk
from repro_torch.data import synthetic_rescal
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.selection import RescalkConfig

FUSED = KernelPolicy(use_fused=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # a relational tensor with 4 planted latent communities
    X, _, _ = synthetic_rescal(n=48, m=3, k=4, seed=0, noise=0.01,
                               device=args.device)
    print(f"tensor: {tuple(X.shape)}  (relations x entities x entities) "
          f"on {X.device}")

    # --- plain factorization at a known rank ---
    gen = torch.Generator(device=X.device).manual_seed(0)
    state, err = rescal(X, 4, generator=gen, iters=300, policy=FUSED)
    print(f"RESCAL @ k=4: rel_err={float(err):.4f}  "
          f"A{tuple(state.A.shape)} R{tuple(state.R.shape)}")

    # --- automatic model selection (the paper's contribution) ---
    cfg = RescalkConfig(k_min=2, k_max=6, n_perturbations=4,
                        rescal_iters=250, kernel=FUSED)
    res = rescalk(X, cfg, verbose=True)
    print(res.summary())
    print(f"\nplanted k=4, selected k_opt={res.k_opt}")
    return res.k_opt


if __name__ == "__main__":
    main()
