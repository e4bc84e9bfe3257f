"""Paper §6.5's model determination in large data, planned for the
PyTorch port: the 3 TB dense and the exabyte-tier sparse RESCAL cells on
the production grids (16 x 16, and 2 x 16 x 16), one rank's memory plan
each, in this process (``repro_torch.launch.dryrun``; no device, no
process group).  Prints each cell's grid, per-rank memory and fit, model
FLOPs per MU iteration beside the rank's counted FLOPs and bytes, and
collectives per MU iteration; exits 1 if a cell does not fit the card.

    PYTHONPATH=src python examples/torch_exascale_dryrun.py
"""
import sys

from repro_torch.configs import RESCAL_CONFIGS
from repro_torch.launch import dryrun

CELLS = [("rescal-dense-3tb", False), ("rescal-sparse-eb", False),
         ("rescal-dense-3tb", True), ("rescal-sparse-eb", True)]


def main() -> int:
    ok = True
    for arch, multi_pod in CELLS:
        cfg = RESCAL_CONFIGS[arch]
        d = dryrun.run_cell(arch, "mu_iter", multi_pod=multi_pod)
        mem, coll, loc = d["memory"], d["collectives"], d["local"]
        print(f"\n=== {arch} on grid {d['mesh']} ({d['devices']} ranks, "
              f"{d['schedule']} schedule) ===")
        if cfg.sparse:
            print(f"  logical tensor: {cfg.m} x {cfg.n:,}^2 fp32 = "
                  f"{cfg.dense_bytes / 1e18:.1f} EB dense equivalent, "
                  f"{cfg.stored_bytes / 1e12:.2f} TB stored (block "
                  f"density {cfg.block_density:.1e}); "
                  f"{loc['nnzb']} blocks of {loc['bs']}^2 per slice per "
                  f"rank, n_loc {loc['nl']:,}")
        else:
            print(f"  tensor: {cfg.m} x {cfg.n:,}^2 fp32 = "
                  f"{cfg.dense_bytes / 1e12:.2f} TB dense; X block "
                  f"({cfg.m}, {loc['nl']}, {loc['nl']}) per rank")
        print(f"  memory/rank {d['rank']}: {mem['total'] / 1e9:.2f} GB "
              f"(argument {mem['argument'] / 1e9:.2f}, temp "
              f"{mem['temp'] / 1e9:.2f}); fits {mem['card']} "
              f"({mem['card_bytes'] / 1e9:.0f} GB): {mem[dryrun.FIT_KEY]}")
        print(f"  model FLOPs/iter (global): "
              f"{d['model_flops_global']:.3e}; counted per rank: "
              f"{d['flops_per_device']:.3e} FLOPs, "
              f"{d['bytes_per_device'] / 1e9:.2f} GB")
        total = coll["total"]
        print(f"  collectives/iter: {total['count']} "
              f"({total['result_bytes'] / 1e9:.3f} GB of payload, "
              f"{total['wire_bytes'] / 1e9:.3f} GB on the wire per rank)")
        ok = ok and mem[dryrun.FIT_KEY] is True
    print("\nAll exascale cells fit one rank's card. OK" if ok else
          "\nA cell does not fit the card.")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
