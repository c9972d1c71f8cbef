"""Serving entry point: batched prefill, then greedy decode against KV caches.

    python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 8 --prompt-len 512 --gen-len 32
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \
        --device cpu
    python -m repro_torch.launch.serve --arch whisper-tiny
    python -m repro_torch.launch.serve --arch internvl2-26b --reduced \
        --device cpu

The port of the JAX package's ``launch/serve.py``: random parameters from
seed 0, one batched prefill that returns the first greedy tokens and the
caches, ``gen_len - 1`` greedy decode steps, and the reference's three
printed lines.  The prompts, and whisper's frame embeddings and internvl's
patch embeddings (stubs of their front ends, as in the reference), are
drawn as the reference draws them.  It runs on the card unless ``--device
cpu`` is given, and raises without a card.  ``serve()`` is the same run as
a function.

A deliberate difference: the caches hold ``n_patches + prompt_len +
gen_len`` positions.  The reference sizes them ``prompt_len + gen_len``
without the prepended patches, and its prefill then writes the prompt's
last positions past the cache's end, where they are dropped.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.steps import make_decode_step, make_prefill_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_batch(cfg, rng: np.random.Generator, requests: int,
               prompt_len: int, dtype=torch.float32, device=None) -> Dict:
    """The prefill batch, in the reference's order from ``rng``: ``tokens``
    (requests, prompt_len), then ``patches`` (requests, n_patches, d) when
    ``cfg.n_patches``, then ``frames`` (requests, enc_len, d) when
    ``cfg.encdec``, both standard normal cast to ``dtype``."""
    dev = resolve_device(device)

    def normal(n):
        return torch.as_tensor(rng.standard_normal((requests, n, cfg.d_model)),
                               device=dev).to(dtype)

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (requests, prompt_len)),
        dtype=torch.int64, device=dev)}
    if cfg.n_patches:
        batch["patches"] = normal(cfg.n_patches)
    if cfg.encdec is not None:
        batch["frames"] = normal(cfg.encdec.enc_len)
    return batch


def serve(cfg, *, requests: int, prompt_len: int, gen_len: int,
          dtype=torch.float32, device=None,
          params: Optional[Dict] = None) -> Dict:
    """Prefill ``requests`` random prompts of ``prompt_len`` tokens and
    decode ``gen_len`` greedy tokens each.  Returns the generated tokens
    (requests, gen_len) as numpy int32, the host-clock seconds of the
    prefill and of the decode loop, each ending in a device synchronize,
    and the MoE drop fractions (summed over the MoE layers, 0 without):
    the prefill's and the mean of the decode steps'.
    The prompts (and patches and frames, ``draw_batch``) come from numpy's
    generator seeded with 0, as the reference's; ``params`` defaults to
    ``tf.init_params(cfg, seed=0)``.  The caches hold the patches too (see
    the module's docstring)."""
    dev = resolve_device(device)
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    cache_len = cfg.n_patches + prompt_len + gen_len
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)
    if params is None:
        params = tf.init_params(cfg, seed=0, dtype=dtype, device=dev)
    batch = draw_batch(cfg, np.random.default_rng(0), requests, prompt_len,
                       dtype, dev)

    _sync(dev)
    t0 = time.perf_counter()
    next_tok, caches, aux_prefill = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out, aux = [next_tok], [aux_prefill]
    t1 = time.perf_counter()
    for _ in range(gen_len - 1):
        next_tok, caches, aux_step = decode(params, caches,
                                            next_tok[:, None])
        out.append(next_tok)
        aux.append(aux_step)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    drop = torch.stack(aux)[:, 1].tolist()
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "moe_drop_frac_prefill": drop[0],
            "moe_drop_frac_decode": (sum(drop[1:]) / (gen_len - 1)
                                     if gen_len > 1 else 0.0)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    b, s, g = args.requests, args.prompt_len, args.gen_len
    res = serve(cfg, requests=b, prompt_len=s, gen_len=g,
                dtype=DTYPES[args.dtype], device=args.device)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    print(f"prefill: {b} x {s} tokens in {t_prefill*1e3:.1f} ms "
          f"({b*s/t_prefill:.0f} tok/s)")
    print(f"decode:  {b} x {g} tokens in {t_decode*1e3:.1f} ms "
          f"({b*g/max(t_decode,1e-9):.0f} tok/s)")
    print(f"sample continuation (request 0): {res['tokens'][0].tolist()}")


if __name__ == "__main__":
    main()
