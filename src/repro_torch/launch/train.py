"""Training launcher of the port (the counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --smoke --device cpu       # a CPU-sized smoke run
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --shape train_4k                       # on the card

Runs on the card unless ``--device cpu`` is passed. Batches are the
deterministic ``SyntheticTokens`` of their step (8 x 64 tokens with
``--smoke``, else the shape's global batch x sequence); an encdec model also
gets frame embeddings and a vlm model patch embeddings, N(0, 1) from a
``torch.Generator`` seeded by the step. Fault tolerance: rolling atomic
checkpoints every ``--ckpt-every`` steps and at the end (``--ckpt-dir``,
default ``$TMPDIR/ckpt_<arch>``); a restarted run resumes from the newest
one and ends with the same state as a run without a break, bit for bit on
the same device. Each save prints ``checkpoint: step N saved``.

The step builds a new state from the old one (``launch.steps``); nothing is
donated, so the reference's fault with donation (its ``adam_init`` gives
both moments one zeros buffer, which ``jax.jit(..., donate_argnums=(0,))``
refuses to donate twice) has no counterpart here. The reference's
multi-host start (``jax.distributed.initialize`` under
``JAX_COORDINATOR``) comes with distributed calibration (ROADMAP Queue 1
item 11).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_shape, get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import ARCH_MODE
from repro_torch.launch.steps import TRAIN_OPT, make_train_step
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import Stopwatch
from repro_torch.optim.adam import adam_init

SMOKE_BATCH = (8, 64)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda")
    return ap


def make_batch(cfg, src: SyntheticTokens, step: int, B: int, S: int,
               device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch on ``device``: tokens and labels, plus
    ``frames`` (B, S, D) for encdec or ``patch_embeds`` (B, n_patches, D)
    for vlm, N(0, 1) in float32 from a generator seeded by the step."""
    batch = {k: v.to(device) for k, v in src.batch(step, B).items()}
    extra = {"encdec": ("frames", S), "vlm": ("patch_embeds", cfg.n_patches)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        gen = torch.Generator(device=device).manual_seed(step)
        batch[key] = torch.randn((B, n, cfg.d_model), generator=gen,
                                 dtype=torch.float32, device=device)
    return batch


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the final state (``{"params", "opt", "step"}``)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = get_shape(args.shape)
    B, S = SMOKE_BATCH if args.smoke else (shape.global_batch, shape.seq_len)

    model = build_model(cfg)
    opt_cfg = TRAIN_OPT[ARCH_MODE.get(cfg.name, "tp")]
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=S, seed=0)

    mgr = CheckpointManager(args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"ckpt_{cfg.name}"), keep=3)
    state, meta = mgr.restore(device=dev)
    if state is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        state = {"params": params, "opt": adam_init(params, opt_cfg),
                 "step": 0}
        start = 0
    else:
        start = int(meta["step"])
        print(f"resumed from step {start}", flush=True)

    step_fn = make_train_step(model, cfg, opt_cfg)
    sw = Stopwatch()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, make_batch(cfg, src, step, B, S, dev))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"({sw.elapsed_s():.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)
            print(f"checkpoint: step {step + 1} saved", flush=True)
    mgr.save(args.steps, state)
    print(f"checkpoint: step {args.steps} saved; training done", flush=True)
    return state


if __name__ == "__main__":
    main()
