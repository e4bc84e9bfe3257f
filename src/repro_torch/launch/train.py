"""LM training launcher of the port (port of ``repro/launch/train.py``):
``--arch <id>`` on the fault-tolerant loop, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 50 --device cpu

Runs on the H100 by default; ``--device cpu`` runs the same path on the
CPU.  The published widths train on the card (llama3.2-1b at seq 4096
needs ``--remat``).  Every decoder-only family trains (dense, MLA,
MoE, SSM, hybrid); the MoE path is "dense" with ``--reduced`` and
"scatter" otherwise, as ``repro``'s launcher picks it.  The enc-dec and
VLM archs exit as ``repro``'s launcher does.

``--mesh pod`` / ``multipod`` train on ``repro``'s production grid (16
x 16, or 2 x 16 x 16; ``launch.mesh.make_production_grid``): one
process per cell under ``torchrun`` (256 or 512 ranks, each on
``cuda:LOCAL_RANK``; any other world is refused), every arch this
launcher trains, tensor and data parallel with ZeRO-1 moments (the MoE
experts EXPERT-else-ff, its groups and balance loss the global
batch's).  ``--device`` is then the grid's.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, REDUCED_ARCHS
from repro_torch.data import TokenStreamConfig, batch_at
from repro_torch.launch.mesh import make_production_grid
from repro_torch.models.model import count_params_analytic
from repro_torch.optim import AdamW
from repro_torch.train import LoopConfig, train_loop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=("none", "pod", "multipod"),
                    help="production grids: 256 / 512 ranks under torchrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> list[dict]:
    """Train; returns the loop's history (one dict per executed step)."""
    args = build_parser().parse_args(argv)
    cfg = (REDUCED_ARCHS if args.reduced else ARCHS)[args.arch]
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit(f"{cfg.name}: token-stream trainer targets "
                         "decoder-only archs; see tests for frontend-stub "
                         "training of encdec/vlm")
    grid = None
    if args.mesh != "none":
        grid = make_production_grid(multi_pod=args.mesh == "multipod")
    n = count_params_analytic(cfg)["total"]
    print(f"train {cfg.name}: {n / 1e6:.1f}M params, mesh={args.mesh}")
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    loop = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      save_every=args.save_every, log_every=10)
    try:
        _, history = train_loop(
            cfg, lambda s: batch_at(ds, s), loop, optimizer=AdamW(lr=args.lr),
            remat=args.remat, moe_impl="dense" if args.reduced else "scatter",
            device=args.device, grid=grid,
            verbose=grid is None or grid.rank == 0)
    finally:
        if grid is not None:
            grid.destroy()
    if history:
        print(f"done: loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
