"""Transformer decode demo of the port (port of
``repro/launch/decode_demo.py``): a batched prefill of random prompts,
then greedy autoregressive decode, on random weights drawn from a seed.

Serves every decoder-only arch of the zoo (dense, MLA, MoE, SSM,
hybrid); enc-dec and VLM exit, as ``repro``'s demo does.  Runs on the
H100 by default (``--device cpu`` runs the plain PyTorch path on the
CPU).  On the card every layer's GQA or MLA prefill attention launches
the hand-written CUDA flash_attention kernel (the SSM and the hybrid's
sliding window launch none, as ``repro``'s run no kernel); the MoE
path is ``repro``'s default, "einsum".

    PYTHONPATH=src python -m repro_torch.launch.decode_demo \\
        --arch deepseek-moe-16b --reduced --batch 4 --prompt-len 16 \\
        --new-tokens 16 --device cpu

Decode continues from the prefill's cache (``Transformer.extend_cache``
to prompt + new-tokens positions); ``repro``'s demo decodes against a
fresh zero cache instead.

``--mesh pod`` / ``multipod`` serve on ``repro``'s production grid (16 x
16, or 2 x 16 x 16; ``launch.mesh.make_production_grid``): one process
per cell under ``torchrun`` (256 or 512 ranks; any other world is
refused), every arch the demo serves (``train.serve_step``: parameters
placed, the prefill's cache in ``cache_specs``' blocks); each cell
prints its own rows' numbers.  ``serve(model, prompts, n, grid=grid)``
is the same on a placed model and any LM grid, enc-dec's frames and the
VLM's patches included.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import ARCHS, REDUCED_ARCHS
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_grid
from repro_torch.models.model import greedy_sample
from repro_torch.models.transformer import Transformer
from repro_torch.train import make_prefill_step, make_serve_step
from repro_torch.train.serve_step import params_shardings


@dataclasses.dataclass
class DemoResult:
    """What one run produced and measured (times on the host's clock,
    around work that ends in a device synchronize)."""
    model: Transformer
    prompts: torch.Tensor          # (B, P)
    inputs: dict                   # enc-dec's frames or the VLM's patches
    start: int                     # the first decode position
    prefill_logits: torch.Tensor   # (B, 1, Vpad), last prompt position
    tokens: torch.Tensor           # (B, T + 1): the prefill's, then T steps
    step_logits: torch.Tensor      # (B, T, Vpad): step t's input tokens[:, t]
    prefill_ms: float
    decode_ms: float
    flash_launches: int            # flash_attention launches in the prefill
    flash_by_variant: dict         # the same, per kernel variant
    peak_bytes: int | None         # peak device memory (None on the CPU)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", default="none",
                    choices=("none", "pod", "multipod"),
                    help="production grids: 256 / 512 ranks under torchrun")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> DemoResult:
    cfg = (REDUCED_ARCHS if args.reduced else ARCHS)[args.arch]
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("token-only server targets decoder-only archs")
    grid = None
    if args.mesh != "none":
        grid = make_production_grid(multi_pod=args.mesh == "multipod")
    dev = grid.device if grid is not None else _device.resolve(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Transformer(cfg, device=dev, gen=gen)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    if grid is None:
        return serve(model, prompts, args.new_tokens)
    try:
        return serve(params_shardings(grid, model), prompts, args.new_tokens,
                     grid=grid)
    finally:
        grid.destroy()


def serve(model: Transformer, prompts: torch.Tensor, new_tokens: int,
          grid=None, **inputs) -> DemoResult:
    """The demo's serving on a built model: a timed prefill of ``prompts``
    (B, P) (with enc-dec's ``frames`` or the VLM's ``patches`` in
    ``inputs``), then ``new_tokens`` timed greedy decode steps from its
    cache.  Prints what it measured.  With ``grid`` (an LM grid, the model
    placed on it: ``train.serve_step.params_shardings``) the prefill
    takes the global prompts and the cache, logits and tokens are this
    cell's rows (``inputs`` are the global batch's too)."""
    cfg, dev = model.cfg, model.device
    B, Pn, T = *prompts.shape, new_tokens
    start = Pn + (inputs["patches"].shape[1] if "patches" in inputs else 0)
    prefill = make_prefill_step(model, grid=grid, max_len=start + T)
    launches0 = ops.launch_counts()["flash_attention"]
    variants0 = _flash.launch_count_by_variant()
    _sync(dev)
    t0 = time.perf_counter()
    logits, filled = prefill(prompts, **inputs)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()["flash_attention"] - launches0
    by_variant = {name: n - variants0[name] for name, n in
                  _flash.launch_count_by_variant().items()}
    print(f"prefill {B}x{Pn}: {prefill_ms:.1f} ms "
          f"({B * Pn / prefill_ms * 1e3:.0f} tok/s)")
    print(f"flash_attention launches in the prefill: {launches} "
          f"({cfg.n_layers} layers; {by_variant})")

    step_fn = make_serve_step(model, grid=grid)
    if grid is None:
        with torch.inference_mode():
            cache = model.extend_cache(filled, start + T)
    else:
        cache = filled
    del filled
    tok = greedy_sample(logits, cfg.vocab)
    B = tok.shape[0]                 # on a grid: this cell's rows
    tokens, steps = [tok], []
    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(start, start + T):
        step_logits, cache = step_fn(cache, tok, pos)
        tok = greedy_sample(step_logits, cfg.vocab)
        tokens.append(tok)
        steps.append(step_logits)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    print(f"decode: {T} steps x {B} seqs in {decode_ms:.1f} ms "
          f"({decode_ms / max(T, 1):.2f} ms/step, "
          f"{B * T / decode_ms * 1e3:.0f} tok/s)")
    peak = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
    empty = logits.new_empty((B, 0, logits.shape[-1]))
    return DemoResult(
        model=model, prompts=prompts, inputs=inputs, start=start,
        prefill_logits=logits, tokens=torch.cat(tokens, dim=1),
        step_logits=torch.cat(steps, dim=1) if steps else empty,
        prefill_ms=prefill_ms, decode_ms=decode_ms, flash_launches=launches,
        flash_by_variant=by_variant, peak_bytes=peak)


def main(argv=None) -> DemoResult:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
