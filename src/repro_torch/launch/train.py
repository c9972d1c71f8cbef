"""Training driver.

    python -m repro_torch.launch.train --arch smollm-135m --steps 200 \
        --batch 8 --seq 256
    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --steps 3 --device cpu --ckpt-dir /tmp/ckpt

The port of the JAX package's ``launch/train.py``, with its flags
(``--arch``, ``--steps``, ``--batch``, ``--seq``, ``--reduced``,
``--dtype``, ``--ckpt-dir``, ``--ckpt-every``, ``--grad-compress``,
``--log-every``) and ``--device``, which defaults to the card (and raises
without one).  Random parameters from seed 0, AdamW with the default
``AdamWConfig``, the synthetic pipeline's batch ``i`` at step ``i``,
checkpoint and restart through ``CheckpointManager`` (parameters, AdamW
state and the pipeline's state), and the reference's per-step line.  The
reference's mesh flags have no counterpart on one card.

``--grad-compress`` behaves as the reference's: it allocates the error
feedback and applies nothing (the reference's step has no compression in
it; ROADMAP Queue C records this).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import SyntheticTextPipeline, make_batch_for
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import compress as gc
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.steps import make_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_batch(batch, dtype, device):
    """A pipeline batch as tensors on ``device``: token ids as int64, the
    patches and frames cast to the model's ``dtype``."""
    return {k: (torch.as_tensor(v, device=device).long()
                if np.issubdtype(v.dtype, np.integer)
                else torch.as_tensor(v, device=device).to(dtype))
            for k, v in batch.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dtype = DTYPES[args.dtype]
    print(f"device: {dev}  arch: {cfg.name}  params: "
          f"~{cfg.param_count():,}")

    step = make_train_step(cfg)
    params = tf.init_params(cfg, seed=0, dtype=dtype, device=dev)
    opt = init_adamw(params)
    err = gc.init_error_feedback(params) if args.grad_compress else None
    pipe = SyntheticTextPipeline(cfg.vocab, shape.seq_len, shape.global_batch)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        (params, opt), start, extra = mgr.restore((params, opt), device=dev)
        pipe.restore(extra["pipeline"])
        print(f"restored checkpoint at step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = device_batch(make_batch_for(cfg, shape, step=i), dtype, dev)
        pipe.step = i + 1
        params, opt, metrics = step(params, opt, batch)
        if args.grad_compress and err is not None:
            pass  # as the reference: nothing applies the compression
        if (i + 1) % args.log_every == 0 or i == start:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i+1:5d}  loss {m['loss']:.4f}  gnorm "
                  f"{m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{(time.time()-t0)/(i-start+1):.2f}s/step")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, (params, opt), extra={"pipeline": pipe.state()})
    if mgr is not None:
        mgr.save(args.steps, (params, opt), extra={"pipeline": pipe.state()})
        mgr.wait()
    print("done.")


if __name__ == "__main__":
    main()
