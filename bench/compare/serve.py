"""What decides ``correct`` in a serving cell.

After the window, a sample of the finished requests, drawn from the seed
with the longest finished request in it, until it holds ``check_tokens``
served tokens. The reference regenerates the float weights from the seed,
quantizes them itself (round-to-nearest on the export recipe's grid, the
wide layers at their bits) and runs the plain forward over each prompt
followed by its served tokens. ``logit_gap`` is the widest gap, over every
served token of the sample, by which the token's reference logit lies
below the reference's best logit at its position: greedy decoding that
agrees with the reference reads the rounding of the program (bf16
activations, W4 kernels, the int8 KV cache).

The control (``control_gap``) puts the reference computed with every
product's operands rounded to float8 e4m3 in the program's place, and
reads the same gap for the token it ranks first at each position.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import spec, weights
from bench.reference import quant


def sample(job, finished: Dict[int, Tuple[np.ndarray, List[int]]]) -> List[int]:
    """Request ids of the sample: the longest finished request, then
    others in an order drawn from the seed, until ``check_tokens``."""
    if not finished:
        return []
    rids = sorted(finished)
    size = {r: len(finished[r][0]) + len(finished[r][1]) for r in rids}
    longest = max(rids, key=lambda r: (size[r], -r))
    rng = np.random.default_rng(weights.stream_seed(job.seed, "sample") % 2**63)
    order = [longest] + [r for r in rng.permutation(rids).tolist() if r != longest]
    out, n = [], 0
    for r in order:
        out.append(r)
        n += len(finished[r][1])
        if n >= job.traffic["check_tokens"]:
            break
    return out


@torch.no_grad()
def reference_logits(job, recipe, seqs: List[np.ndarray], positions: List[np.ndarray],
                     low: bool = False) -> List[torch.Tensor]:
    """The reference's logits (float32) at ``positions`` of each sequence;
    weights round-to-nearest on the export's grid; ``low``: every product's
    operands rounded to float8 e4m3 (the control)."""
    arch, dev = job.arch, job.device
    ex = job.traffic["export"]
    last = arch["n_layers"] - 1
    wide = {last if i < 0 else i for i in ex["wide_layers"]}
    ref = spec.reference(job.config["reference"]).Model(arch, job.seed, dev)
    S = max(len(s) for s in seqs)
    toks = torch.zeros((len(seqs), S), dtype=torch.long, device=dev)
    for b, s in enumerate(seqs):
        toks[b, :len(s)] = torch.as_tensor(s, device=dev)
    x = ref.embed(toks)
    if low:
        def mm(a, w):
            return quant.fp8(a) @ quant.fp8(w.T).T
    else:
        def mm(a, w):
            return a @ w
    for i in range(arch["n_layers"]):
        p = ref.layer(i)
        bits = ex["wide_bits"] if i in wide else ex["recipe"]["w_bits"]
        wq = {s: quant.rtn_weight(w, bits, ex["recipe"]["w_observer"])
              for s, w in ref.sites(p).items()}

        def lin(site, a, w, b, wq=wq):
            y = mm(a, wq[site.partition(".")[2]])
            return y if b is None else y + b

        x = torch.cat([ref.block(p, x[b:b + 1], lin) for b in range(len(seqs))])
        del p, wq
    x = ref.final_norm(x)
    head = ref.head()
    out = []
    for b, pos in enumerate(positions):
        h = x[b, torch.as_tensor(pos, device=dev)]
        out.append(mm(h, head) * arch.get("logit_mult", 1.0))
    return out


def _inputs(finished, rids):
    seqs, positions, served = [], [], []
    for r in rids:
        prompt, toks = finished[r]
        toks = np.asarray(toks, dtype=np.int64)
        seqs.append(np.concatenate([prompt, toks[:-1]]))
        positions.append(np.arange(len(prompt) - 1, len(prompt) - 1 + len(toks)))
        served.append(toks)
    return seqs, positions, served


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Best logit minus the logit of ``tokens``, position by position."""
    t = torch.as_tensor(tokens, device=logits.device)
    return logits.max(-1).values - logits.gather(-1, t[:, None])[:, 0]


def numbers(job, recipe, finished) -> Tuple[Dict[str, Dict[str, float]], int]:
    rids = sample(job, finished)
    if not rids:
        return {"logit_gap": {"value": float("inf"),
                              "limit": job.limits["logit_gap"]}}, 1
    seqs, positions, served = _inputs(finished, rids)
    logits = reference_logits(job, recipe, seqs, positions)
    per = [float(gaps(lg, tk).max()) for lg, tk in zip(logits, served)]
    lim = job.limits["logit_gap"]
    return ({"logit_gap": {"value": max(per), "limit": lim}},
            sum(g > lim for g in per))


def control(job, recipe, finished) -> Dict[str, float]:
    """The program's reading and the control's on the same sample."""
    rids = sample(job, finished)
    seqs, positions, served = _inputs(finished, rids)
    ref = reference_logits(job, recipe, seqs, positions)
    low = reference_logits(job, recipe, seqs, positions, low=True)
    prog = max(float(gaps(lg, tk).max()) for lg, tk in zip(ref, served))
    ctrl = max(float(gaps(r, l.argmax(-1)).max()) for r, l in zip(ref, low))
    return {"logit_gap": prog, "control_gap": ctrl}
