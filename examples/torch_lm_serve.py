"""Serve a small model of the PyTorch port with batched requests: prefill
and greedy autoregressive decode through the serving steps (the
counterpart of examples/lm_serve.py).

    PYTHONPATH=src python examples/torch_lm_serve.py --device cpu

Runs on the GPU by default, where every layer's prefill attention
launches the CUDA flash_attention kernel.  Random weights from seed 0.
"""
import argparse
import time

import torch

from repro_torch.configs import REDUCED_ARCHS
from repro_torch.models.model import greedy_sample
from repro_torch.models.transformer import Transformer
from repro_torch.train import decode_loop, make_prefill_step


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    dense = sorted(n for n, c in REDUCED_ARCHS.items()
                   if c.family == "dense" and c.attn_impl == "gqa")
    ap.add_argument("--arch", default="llama3.2-1b", choices=dense)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = REDUCED_ARCHS[args.arch]
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, device=dev, gen=gen)
    B, P, T = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    print(f"arch={cfg.name}  batch={B}  prompt={P}  new={T}  on {dev}")

    # --- prefill: one pass, returns last logits + populated cache ---
    t0 = time.perf_counter()
    logits, prefill_cache = make_prefill_step(model)(prompts)
    tok = greedy_sample(logits, cfg.vocab)
    print(f"prefill: {(time.perf_counter() - t0) * 1e3:.0f} ms")

    # decode continues in a max-length cache
    cache = model.init_cache(B, P + T)
    for name in ("k", "v"):
        cache[name][:, :, :P] = prefill_cache[name]
    t0 = time.perf_counter()
    out, cache = decode_loop(model, cache, tok, P, T - 1)
    dt = time.perf_counter() - t0
    print(f"decode: {T - 1} steps x {B} seqs in {dt * 1e3:.0f} ms "
          f"({B * (T - 1) / dt:.0f} tok/s)")
    print("generated token ids, request 0:", out[0].tolist())
    assert out.shape == (B, T) and int(out.max()) < cfg.vocab
    print("OK")
    return out


if __name__ == "__main__":
    main()
