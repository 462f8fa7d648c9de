"""Train a small LM end to end with the port's substrate: the data
pipeline, Adam (optionally bfloat16 or int8 moments), checkpoint and
restart, straggler-tolerant batch assembly (the counterpart of
``examples/train_small.py``).

    PYTHONPATH=src python examples/torch_train_small.py --steps 200   # card
    PYTHONPATH=src python examples/torch_train_small.py --device cpu \\
        --steps 60 --simulate-failure-at 52    # then rerun it: it resumes

A checkpoint is saved every 50 steps and at the end; a rerun of the same
command resumes from the newest one in ``--ckpt``.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchConfig
from repro_torch.core import QuantCtx
from repro_torch.data import (StragglerPolicy, SyntheticTokens,
                              assemble_global_batch)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.adam import tree_leaves, tree_unflatten

CFG = ArchConfig(name="train-demo", family="dense", n_layers=4, d_model=128,
                 n_heads=4, n_kv_heads=2, d_ff=256, vocab=256,
                 dtype="float32", attn_chunk=64, xent_chunk=64, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "train_small_ckpt"))
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build_model(CFG)
    opt_cfg = AdamConfig(lr=3e-3, grad_clip=1.0,
                         moment_dtype=args.moment_dtype)
    src = SyntheticTokens(vocab=CFG.vocab, seq_len=64, seed=0)
    mgr = CheckpointManager(args.ckpt, keep=2)
    n_hosts = 4
    policy = StragglerPolicy(min_fraction=0.5)

    state, meta = mgr.restore(device=dev)
    if state is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        state = {"params": params, "opt": adam_init(params, opt_cfg),
                 "step": 0}
        start = 0
    else:
        start = int(meta["step"])
        print(f"resumed from step {start}")

    def train_step(state, batch, weight):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state["params"])]
        loss, _ = model.loss(tree_unflatten(state["params"], leaves), batch,
                             QuantCtx(mode="fp"))
        loss = loss * (weight.shape[0] / torch.clamp(weight.sum(), min=1.0))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params, opt, _ = adam_update(
                tree_unflatten(state["params"], grads), state["opt"],
                state["params"], opt_cfg)
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                loss.detach())

    for step in range(start, args.steps):
        # per-host shards; every 37th step a host straggles past the deadline
        shards = [{k: v.numpy() for k, v in
                   src.batch(step, 16, host=h, n_hosts=n_hosts).items()}
                  for h in range(n_hosts)]
        if step % 37 == 36:
            shards[step % n_hosts] = None
        batch, weight = assemble_global_batch(shards, policy)
        state, loss = train_step(state, {k: v.to(dev)
                                         for k, v in batch.items()},
                                 weight.to(dev))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}")
        if step % 50 == 49:
            mgr.save(step + 1, state)
        if step == args.simulate_failure_at:
            print("simulated crash — rerun the same command to resume")
            return
    mgr.save(args.steps, state)
    print("done; checkpoints in", args.ckpt)


if __name__ == "__main__":
    main()
