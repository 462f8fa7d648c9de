"""Serve the quantized bench LM with batched requests (the counterpart of
``examples/serve_quantized.py``; the paper's kind is PTQ for deployment,
so serving is the scenario it dictates):

  1. pretrain/load the small LM (``repro_torch.launch.bench_lm``),
  2. FlexRound-quantize its weights to int8 and to int4 (weight-only,
     per-channel, exported as QTensors),
  3. run a minimal batched engine, a pad-batch prefill then a lockstep
     greedy decode, and print tokens/s, weight MiB and the greedy tokens'
     agreement with the unquantized weights for each variant.

    PYTHONPATH=src python examples/torch_serve_quantized.py        # card
    PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu \\
        --train-steps 20 --iters 4 --calib 16 --tokens 8

The ``bf16`` row serves the trained float32 weights, as the reference's
row of that name does. In deploy mode every QTensor linear goes through
``kernels/ops.qtensor_matmul``: on the card the hand-written kernels
(``--backend kernel``, or ``auto``), on the CPU their plain versions.
"""
import argparse
import time

import torch

from repro_torch.core import QuantCtx, QuantRecipe
from repro_torch.core.qtensor import tree_weight_bytes
from repro_torch.device import resolve_device
from repro_torch.launch import bench_lm

PROMPT_LENS = (8, 12, 16, 9, 14, 10, 16, 8)


class ServingEngine:
    """Minimal batched engine: pad-batch prefill, lockstep decode."""

    def __init__(self, model, params, max_len=128, backend="auto"):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.ctx = QuantCtx(mode="deploy", backend=backend)

    def generate(self, prompts, n_tokens, forced=None):
        """(B, n_tokens) greedy tokens and the (B, n_tokens, V) logits of
        each step; ``forced`` (B, n_tokens): feed these tokens instead of
        the greedy ones (a teacher-forced re-run of another decode)."""
        dev = self.params["embed"].device
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = torch.tensor([[0] * (S - len(p)) + list(p) for p in prompts],
                            dtype=torch.long, device=dev)
        with torch.no_grad():
            cache = self.model.init_cache(B, self.max_len, device=dev)
            _, cache = self.model.prefill(self.params, toks, cache, self.ctx)
            out, logs = [], []
            cur = toks[:, -1:]
            for t in range(n_tokens):
                logits, cache = self.model.decode_step(
                    self.params, cur, cache, S + t, self.ctx)
                cur = torch.argmax(logits[:, -1:], dim=-1)
                out.append(cur)
                logs.append(logits[:, -1])
                if forced is not None:
                    cur = forced[:, t:t + 1]
        return torch.cat(out, dim=1), torch.stack(logs, dim=1)


def prompts(batch: int, vocab: int):
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, vocab, (n,), generator=gen).tolist()
            for n in PROMPT_LENS[:batch]]


def variants(model, params, iters: int, calib: int):
    """{"bf16": params, "int8": ..., "int4": ...}: weight-only per-channel
    FlexRound exports of ``iters`` Adam steps."""
    out = {"bf16": params}
    for bits, tag in ((8, "int8"), (4, "int4")):
        recipe = QuantRecipe(method="flexround", w_bits=bits, a_bits=None,
                             w_granularity="per_channel", iters=iters,
                             lr=3e-3, batch_size=16)
        out[tag], _, _ = bench_lm.ptq(model, params, recipe, calib,
                                      as_qtensor=True)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "torch"])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda")
    ap.add_argument("--iters", type=int, default=80,
                    help="FlexRound Adam steps of each quantized variant")
    ap.add_argument("--train-steps", type=int, default=bench_lm.TRAIN_STEPS,
                    help="the bench LM's pretraining steps")
    ap.add_argument("--calib", type=int, default=64,
                    help="calibration sequences")
    ap.add_argument("--cache-dir", default=bench_lm.CACHE,
                    help="where the pretrained bench LM is cached")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model, params = bench_lm.get_trained_lm(args.train_steps, device=dev,
                                            cache_dir=args.cache_dir)
    reqs = prompts(args.batch, bench_lm.BENCH_CFG.vocab)

    ref, results = None, {}
    for tag, p in variants(model, params, args.iters, args.calib).items():
        eng = ServingEngine(model, p, backend=args.backend)
        eng.generate(reqs, 4)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        out, _ = eng.generate(reqs, args.tokens)
        _sync(dev)
        tps = args.batch * args.tokens / (time.perf_counter() - t0)
        if ref is None:
            ref = out
        agree = float(torch.mean((out == ref).float()))
        mib = tree_weight_bytes(p) / 2**20
        print(f"{tag:5s}: {tps:8.1f} tok/s  weights={mib:6.1f} MiB  "
              f"greedy-token agreement vs bf16: {agree:.2%}")
        results[tag] = {"tok_s": tps, "weight_mib": mib, "agreement": agree,
                        "params": p, "tokens": out}
    print("\nThe int8/int4 variants cut the weight bytes a decode step reads "
          "4x/8x against the float32 weights (the card's K2/K1 kernels read "
          "the codes directly); on the CPU the win shows as weight bytes. "
          "Token agreement ~1.0 validates the quantization.")
    return results


if __name__ == "__main__":
    main()
