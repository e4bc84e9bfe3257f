"""One factorization's MU loop on one rank's share, through
``dist.engine.make_mu_step`` on a 1 x 1 grid (fused kernel policy, the
configuration's schedule); iterations back to back, no host sync inside
the window.

The checked steps run as the window's do, queued back to back with no
sync between them: set-up drives the step from the seeded factors
through its first ``checked_steps`` iterations and copies their states
out only after the last; the window's own last iteration is kept with
its input.  The reference follows the first from the seed, and the last
from the state the window's thousands of iterations ended in.
"""
from __future__ import annotations

import time

import torch

from portbench.drivers import record, synchronize
from portbench.harness import inputs
from portbench.harness.compare import over, worst_gap
from portbench.reference import mu as ref_mu


class Driver:
    # the port's calls the traced run names in its host ranges
    host_ranges = (("repro_torch.dist.engine", "sparse_products", "products"),
                   ("repro_torch.dist.engine", "dense_products", "products"),
                   ("repro_torch.dist.engine", "a_ratio", "a_ratio"))

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.control = control
        self.share = config["share"]
        self.k = config["k"]
        self.checked = traffic["checked_steps"]
        self.iterations = 0

    # -- inputs ------------------------------------------------------------

    def _operands(self):
        sh, dev = self.share, self.device
        if sh["operand"] == "dense":
            X = inputs.dense_block(self.seed, sh["m"], sh["n_local"], dev)
            return X, ref_mu.Dense(X)
        bs = sh["bs"]
        p = inputs.bcsr_shard(self.seed, sh["m"], sh["n_local"] // bs,
                              sh["nnzb"], bs, dev,
                              pattern_seed=sh.get("pattern_seed"))
        from repro_torch.core.sparse import BCSR
        sp = BCSR(data=p.data, block_rows=p.rows, block_cols=p.cols,
                  n=sh["n_local"])
        return sp, ref_mu.Blocks(p.data, p.rows, p.cols, p.nb)

    def _init(self):
        sh = self.share
        return inputs.uniform_factors(self.seed, sh["n_local"], sh["m"],
                                      self.k, self.device)

    # -- the timed path ------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.dist.engine import DistRescalConfig, make_mu_step
        from repro_torch.kernels.policy import KernelPolicy
        from repro_torch.launch.mesh import make_grid
        self.grid = make_grid(data=1, model=1, device=self.device)
        self.operand, self.ref_op = self._operands()
        if self.control:
            op = self.ref_op

            def step(_, A, R):
                with ref_mu.precision(tf32=True):
                    return ref_mu.mu_iteration(op, A, R)
            self.step = step
        else:
            self.step = make_mu_step(self.grid, DistRescalConfig(
                schedule=self.config["schedule"],
                kernel=KernelPolicy(use_fused=True)))
        A, R = self._init()
        states = []
        for _ in range(self.checked):
            with record("mu_step"):
                A, R = self.step(self.operand, A, R)
            states.append((A, R))
        self.start = [(a.cpu(), r.cpu()) for a, r in states]
        del states
        self.A, self.R = A, R
        synchronize(self.device)

    def window(self, seconds: float) -> None:
        """Steps until ``seconds`` have passed; the one issued after that
        is the last, and its input is kept for the check."""
        step, X = self.step, self.operand
        A, R = self.A, self.R
        self.A = self.R = None   # each input A freed once the next exists
        t0 = time.perf_counter()
        last = False
        while not last:
            last = time.perf_counter() - t0 >= seconds
            if last:
                self.end_in = (A, R)
            with record("mu_step"):
                A, R = step(X, A, R)
            self.iterations += 1
        self.end_out = (A, R)

    def work(self) -> dict:
        return {"iterations": self.iterations}

    def attempted(self) -> int:
        return self.iterations

    # -- the comparison ------------------------------------------------------

    def release(self) -> None:
        """The window's last step, its input and its output, copied to the
        host; then the program's state is freed."""
        self.end_in = tuple(x.cpu() for x in self.end_in)
        self.end_out = tuple(x.cpu() for x in self.end_out)
        self.step = None
        synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The worst element gaps of A and of R over the checked steps:
        the first ``checked_steps`` from the seeded factors, and the
        window's last (each step's gaps are kept for ``failed``)."""
        dev = self.device
        pairs = []
        with ref_mu.precision(tf32=False):
            A, R = self._init()
            for got in self.start:
                A, R = ref_mu.mu_iteration(self.ref_op, A, R)
                pairs.append((got, (A, R)))
            A_in, R_in = (x.to(dev) for x in self.end_in)
            pairs.append((self.end_out,
                          ref_mu.mu_iteration(self.ref_op, A_in, R_in)))
        self.steps = [{"A_gap": worst_gap(g[0], r[0].cpu()),
                       "R_gap": worst_gap(g[1], r[1].cpu())}
                      for g, r in pairs]
        return {name: max(s[name] for s in self.steps)
                for name in ("A_gap", "R_gap")}

    def failed(self, limits: dict) -> int:
        return sum(1 for s in self.steps if over(s, limits))

    def close(self) -> None:
        self.operand = self.ref_op = None
        grid, self.grid = getattr(self, "grid", None), None
        if grid is not None:
            grid.destroy()
