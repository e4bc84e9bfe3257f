"""End-to-end LM training on the PyTorch port's fault-tolerant loop
(the counterpart of examples/lm_train.py): synthetic token stream ->
train step -> checkpoint/restart -> loss curve.

The default preset is CPU-sized; ``--preset 100m`` builds a ~100M-param
llama for the GPU (the same code path).  ``--chaos`` injects one
transient failure at the middle step through the ``train/step`` fault
seam, and the loop restores its last checkpoint and replays.

    PYTHONPATH=src python examples/torch_lm_train.py --steps 60 --device cpu
"""
import argparse
import tempfile

from repro_torch.configs import REDUCED_ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.data import TokenStreamConfig, batch_at
from repro_torch.models.model import count_params_analytic
from repro_torch.optim import AdamW
from repro_torch.resilience import FaultPlan, FaultSpec, faults
from repro_torch.train import LoopConfig, train_loop

PRESETS = {
    "tiny": REDUCED_ARCHS["llama3.2-1b"],
    "100m": ArchConfig(name="llama-100m", family="dense", n_layers=8,
                       d_model=768, n_heads=12, n_kv=4, head_dim=64,
                       d_ff=2048, vocab=32000, dtype="float32"),
}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a failure mid-run to demo restart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    n = count_params_analytic(cfg)["total"]
    print(f"arch={cfg.name}  params={n / 1e6:.1f}M  steps={args.steps}")
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                           seed=0)
    plan = FaultPlan()
    if args.chaos:
        plan.add("train/step", FaultSpec(kind="raise-transient",
                                         at=(args.steps // 2,),
                                         message="injected node failure"))
    with tempfile.TemporaryDirectory() as tmp:
        loop = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or tmp,
                          save_every=max(args.steps // 4, 1), log_every=10,
                          seed=0)
        with faults.active(plan):
            state, history = train_loop(
                cfg, lambda s: batch_at(ds, s), loop,
                optimizer=AdamW(lr=1e-3), remat=False, device=args.device,
                verbose=True)
    for f in plan.fired:
        print(f"[chaos] injected failure at step {f['step']}")
    if not history:
        print(f"nothing to do: checkpoint in {args.ckpt_dir} is already at "
              f"step >= {args.steps} (use a fresh --ckpt-dir)")
        return history
    first, last = history[0]["loss"], history[-1]["loss"]
    stragglers = sum(h["straggler"] for h in history)
    print(f"\nloss {first:.4f} -> {last:.4f}  "
          f"({len(history)} recorded steps, {stragglers} stragglers, "
          f"final step={int(state.step)})")
    assert last < first
    print("OK")
    return history


if __name__ == "__main__":
    main()
