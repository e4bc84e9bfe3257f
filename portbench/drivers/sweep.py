"""The RESCALk model selection on a planted tensor of the share's shape,
through ``selection.scheduler.SweepScheduler(mode="batched", grid=<1 x
1>)``, whole sweeps back to back; set-up runs one sweep of single
iterations, which meets every shape.  The reference runs the sweep once,
and every sweep of the window is held to it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.drivers import record, synchronize
from portbench.harness import inputs
from portbench.harness.compare import over, relative_gap, worst_gap
from portbench.reference import mu as ref_mu
from portbench.reference import sweep as ref_sweep


@dataclasses.dataclass
class SweepAnswer:
    """What one sweep answers, per rank and overall."""
    k_opt: int
    per_k: dict      # k -> dict of rel_err, member_errors, A_median,
                     #      R_regress


def _answer(k_opt, per_k) -> SweepAnswer:
    """A sweep's answer from its per-rank results (the port's ``KResult``
    or the reference's ``RankResult``: the same field names)."""
    return SweepAnswer(k_opt=int(k_opt), per_k={
        int(k): {"rel_err": float(r.rel_err),
                 "member_errors": np.asarray(r.member_errors),
                 "A_median": np.asarray(r.A_median),
                 "R_regress": np.asarray(r.R_regress)}
        for k, r in per_k.items()})


class Driver:

    host_ranges = (
        ("repro_torch.selection.scheduler", "run_grid_ensemble", "ensemble"),
        ("repro_torch.selection.scheduler", "custom_cluster", "clustering"),
        ("repro_torch.selection.scheduler", "silhouettes", "silhouettes"),
        ("repro_torch.selection.scheduler", "local_regress_R", "regression"),
        ("repro_torch.selection.scheduler", "local_rel_error", "rel_error"),
        ("repro_torch.selection.ensemble", "local_rel_error",
         "member_errors"),
        ("repro_torch.selection.ensemble", "local_normalize", "normalize"))

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.control = control
        self.share = config["share"]
        self.answers: list[SweepAnswer] = []

    def _settings(self, warm: bool = False) -> dict:
        c, t = self.config, self.traffic
        return dict(ks=list(range(c["k_min"], c["k_max"] + 1)),
                    members=c["n_perturbations"],
                    iters=1 if warm else c["rescal_iters"],
                    regress_iters=1 if warm else t["regress_iters"],
                    delta=t["perturbation_delta"],
                    sil_threshold=t["sil_threshold"])

    def _port_config(self, s: dict):
        from repro_torch.kernels.policy import KernelPolicy
        from repro_torch.selection.types import RescalkConfig
        return RescalkConfig(
            k_min=s["ks"][0], k_max=s["ks"][-1], n_perturbations=s["members"],
            perturbation_delta=s["delta"], rescal_iters=s["iters"],
            regress_iters=s["regress_iters"], init="random",
            schedule=self.config["schedule"], seed=self.seed,
            sil_threshold=s["sil_threshold"],
            kernel=KernelPolicy(use_fused=True))

    def _reference_sweep(self, s: dict, tf32: bool) -> SweepAnswer:
        with ref_mu.precision(tf32=tf32):
            per_k, k_opt = ref_sweep.sweep(
                self.X, s["ks"], members=s["members"], iters=s["iters"],
                regress_iters=s["regress_iters"], delta=s["delta"],
                draws=self.draws, sil_threshold=s["sil_threshold"])
        return _answer(k_opt, per_k)

    def _one(self, s: dict) -> SweepAnswer:
        if self.control:
            return self._reference_sweep(s, tf32=True)
        from repro_torch.selection.scheduler import SweepScheduler
        sched = SweepScheduler(self._port_config(s), mode="batched",
                               criterion=self.traffic["criterion"],
                               draws=self.draws, grid=self.grid)
        res = sched.run(self.X)
        return _answer(res.k_opt, res.per_k)

    def setup(self) -> None:
        from repro_torch.launch.mesh import make_grid
        sh, p = self.share, self.traffic["planted"]
        self.grid = make_grid(data=1, model=1, device=self.device)
        self.X = inputs.planted(self.seed, sh["m"], sh["n_local"],
                                p["k_true"], p["background"], p["noise"],
                                self.device)
        self.draws = inputs.SeedDraws(self.seed, self.device)
        with record("sweep"):
            self._one(self._settings(warm=True))
        synchronize(self.device)

    def window(self, seconds: float) -> None:
        s = self._settings()
        t0 = time.perf_counter()
        while True:
            with record("sweep"):
                self.answers.append(self._one(s))
            if time.perf_counter() - t0 >= seconds:
                break

    def work(self) -> dict:
        return {"sweeps": len(self.answers)}

    def attempted(self) -> int:
        return len(self.answers)

    def release(self) -> None:
        synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Every sweep of the window against one reference sweep: the
        relative gap of each rank's error and of its members' errors, the
        worst element gaps of the median A and the regressed R, and the
        sweeps whose k differs."""
        ref = self._reference_sweep(self._settings(), tf32=False)
        self.sweeps = [_gaps(a, ref) for a in self.answers]
        names = set().union(*self.sweeps)
        return {n: max(g.get(n, float("inf")) for g in self.sweeps)
                for n in names}

    def failed(self, limits: dict) -> int:
        return sum(1 for g in self.sweeps if over(g, limits))

    def close(self) -> None:
        self.X = None
        grid, self.grid = getattr(self, "grid", None), None
        if grid is not None:
            grid.destroy()


def _gaps(got: SweepAnswer, ref: SweepAnswer) -> dict:
    if set(got.per_k) != set(ref.per_k):
        return {"k_opt_miss": 1.0, "rel_err_gap": float("inf")}
    ks = sorted(ref.per_k)
    g, r = got.per_k, ref.per_k
    return {
        "rel_err_gap": max(relative_gap(g[k]["rel_err"], r[k]["rel_err"])
                           for k in ks),
        "member_err_gap": max(worst_gap(g[k]["member_errors"],
                                        r[k]["member_errors"]) for k in ks),
        "A_median_gap": max(worst_gap(g[k]["A_median"], r[k]["A_median"])
                            for k in ks),
        "R_regress_gap": max(worst_gap(g[k]["R_regress"], r[k]["R_regress"])
                             for k in ks),
        "k_opt_miss": float(got.k_opt != ref.k_opt),
    }
