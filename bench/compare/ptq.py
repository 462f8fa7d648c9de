"""What decides ``correct`` in a PTQ cell.

The reference (``bench/reference``) regenerates the weights, takes the
calibration tokens the benchmark drew, and works out again what the
program derives from them, in the configuration's type (bfloat16 weights
and streams, products on bfloat16 operands, quantizers and the loss in
float32). It reconstructs two blocks by the paper's procedure, each from
its own start: observer grids, LSQ ranges over the student stream, the
minibatches and QDrop masks drawn from the seed by the program's stated
rule (a block's seed is the next draw of a CPU generator seeded with the
recipe's seed; a site's QDrop stream is seeded from it and the crc32 of
the site's name), and Adam.

- Block 0, run in set-up: ``loss1_gap`` is the relative gap of the first
  step's loss, which no update has touched (the start: grids, ranges,
  minibatch, masks); ``loss23_gap`` the larger of the second's and the
  third's (the updates).
- The last block the window finished, ``k``: the reference runs all of
  its steps. ``wloss1_gap`` as ``loss1_gap`` (the captured step replayed
  on the block's own buffers); ``werr_gap`` the gap of the error after
  the last step (every step: Adam, its learning rates, the projection).
  Block ``k``'s later losses and its exported codes are not compared:
  Adam moves every leaf by about its learning rate whatever the size of
  its gradient, so the leaves whose gradient is all but nought walk apart
  on the two sides, and after a block's 200 steps about half the codes
  differ.
- ``err_gap``: block ``k``'s error as the program reports it, against the
  reference's error of the block the program exported (its codes and LSQ
  states read back): the export itself.

Block ``k``'s student stream is the one thing the reference does not
derive on its own: it advances the stream through the program's exported
blocks before ``k`` (codes and LSQ states, the program's answers, each
layer on its static 8-bit grid), since redoing every block's steps would
take longer than the window. The start is checked on block 0 from the
reference's own stream, and each export by ``err_gap`` of the block that
ends the window. The student stream itself is not compared: where rounding
moves an activation across a boundary of its 8-bit grid the element moves
a whole grid step, and the streams part by a few percent.

With ``precision="fp8"`` every product rounds both operands to float8
e4m3 first: the control.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Callable, Dict

import torch

from bench import spec
from bench.reference import quant

ROWS = 4  # sequences per reference pass


def block_seed(recipe_seed: int, index: int) -> int:
    """Block ``index``'s seed: the next draw of a CPU generator seeded with
    the recipe's seed, one draw per block."""
    gen = torch.Generator()
    gen.manual_seed(int(recipe_seed))
    for _ in range(index + 1):
        s = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return s


def site_seed(seed: int, name: str) -> int:
    salt = zlib.crc32(name.encode()) & 0x7FFFFFFF
    h = hashlib.blake2b(f"{seed}:{salt}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2 ** 63 - 1)


def _codes(qt) -> torch.Tensor:
    """The integer codes of an exported weight at its logical shape: two
    4-bit codes a byte along K, the even row in the low nibble."""
    c = qt.codes.to(torch.int32)
    if qt.packed:
        c = torch.stack([c & 0xF, (c >> 4) & 0xF], dim=1).reshape(qt.shape)
    return c


def _mm(low: bool, act: torch.dtype) -> Callable:
    """A product on ``act`` operands, or with both operands in float8 (the
    control), its result in ``act``."""
    if not low:
        return lambda x, w: x @ w
    return lambda x, w: (quant.fp8(x.float()) @ quant.fp8(w.float().T).T).to(act)


def _bias(y, b):
    return y if b is None else y + b


def _over_rows(fn, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    for r in range(0, x.shape[0], ROWS):
        out[r:r + ROWS] = fn(x[r:r + ROWS])
    return out


class _Recon:
    """Block ``j``'s reconstruction from the reference's own start on the
    student stream ``x_q`` and the teacher's output ``y_fp``."""

    def __init__(self, ref, recipe, j: int, x_q: torch.Tensor,
                 y_fp: torch.Tensor, mm: Callable):
        dev, act = x_q.device, ref.act
        self.ref, self.recipe, self.mm = ref, recipe, mm
        self.x_q, self.y_fp = x_q, y_fp
        self.p, self.name = ref.layer(j), f"layers.{j}"
        self.w = {f"{self.name}.{s}": v for s, v in ref.sites(self.p).items()}
        self.st = {s: quant.flexround_init(v, recipe.w_bits, recipe.w_observer)
                   for s, v in self.w.items()}
        ranges: Dict[str, Any] = {}

        def record(site, x, wt, b):
            lo, hi = float(x.float().min()), float(x.float().max())
            if site in ranges:
                lo, hi = min(lo, ranges[site][0]), max(hi, ranges[site][1])
            ranges[site] = (lo, hi)
            return self.fp_lin(site, x, wt, b)

        with torch.no_grad():
            for r in range(0, x_q.shape[0], ROWS):
                ref.block(self.p, x_q[r:r + ROWS], record, self.name)
        self.ast = {s: {k: v.to(dev) for k, v in
                        quant.lsq_init(*ranges[s], recipe.a_bits).items()}
                    for s in self.w}
        bseed = block_seed(recipe.seed, j)
        gen = torch.Generator(device=dev)
        gen.manual_seed(bseed)
        n = x_q.shape[0]
        bs = min(recipe.batch_size, n)
        self.idx = (torch.argsort(torch.rand((recipe.iters, n), generator=gen,
                                             device=dev), dim=1)[:, :bs]
                    if bs < n else None)
        self.gens = {}
        for s in self.w:
            self.gens[s] = torch.Generator(device=dev)
            self.gens[s].manual_seed(site_seed(bseed, s))
        leaves, lrs = [], []
        for s in self.w:
            for k in ("s1", "s2", "s3"):
                self.st[s][k].requires_grad_(True)
                leaves.append(self.st[s][k])
                lrs.append(recipe.lr)
            for k in ("step", "beta"):
                self.ast[s][k] = self.ast[s][k].clone().requires_grad_(True)
                leaves.append(self.ast[s][k])
                lrs.append(recipe.lr_lsq)
        self.leaves = leaves
        self.adam = quant.Adam(leaves, lrs)
        self.t = 0
        self.act = act

    def fp_lin(self, site, x, wt, b):
        return _bias(self.mm(x, wt), b)

    def _recon_lin(self, drop: bool):
        recipe = self.recipe

        def lin(site, x, wt, b):
            xh = quant.lsq_act(x.float(), self.ast[site],
                               recipe.a_bits).to(self.act)
            if drop and recipe.setting == "qdrop":
                xh = quant.qdrop(x, xh, self.gens[site], recipe.drop_prob)
            wh = quant.flexround_weight(self.w[site], self.st[site],
                                        recipe.w_bits).to(self.act)
            return _bias(self.mm(xh, wh), b)
        return lin

    def step(self) -> float:
        """One Adam step on the step's minibatch; returns its loss."""
        n = self.x_q.shape[0]
        rows = (self.idx[self.t] if self.idx is not None
                else torch.arange(n, device=self.x_q.device))
        xb, yb = self.x_q[rows], self.y_fp[rows]
        y = self.ref.block(self.p, xb, self._recon_lin(True), self.name)
        loss = torch.mean(torch.square(y.float() - yb.float()))
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        self.adam.step(grads)
        with torch.no_grad():
            for s in self.w:
                for k in ("s1", "s2", "s3"):
                    self.st[s][k].clamp_(min=1e-6)
                self.ast[s]["step"].clamp_(min=1e-8)
        self.t += 1
        return float(loss.detach())

    @torch.no_grad()
    def error(self) -> float:
        """Mean squared error of the block's output over the whole stream,
        QDrop off."""
        lin = self._recon_lin(False)
        y = _over_rows(lambda x: self.ref.block(self.p, x, lin, self.name),
                       self.x_q)
        return _mse(y, self.y_fp)


def _mse(y: torch.Tensor, y_fp: torch.Tensor) -> float:
    se = sum(float(torch.sum(torch.square(y[r:r + ROWS].float()
                                          - y_fp[r:r + ROWS].float())))
             for r in range(0, y.shape[0], ROWS))
    return se / y_fp.numel()


def _gap(a: float, b: float) -> float:
    return abs(a - b) / b


def readings(job, recipe, calib: torch.Tensor, ans: Dict[str, Any],
             precision: str = "ref") -> Dict[str, float]:
    """Every compared number of a run (``precision="fp8"``: the control's)."""
    low = precision == "fp8"
    act = getattr(torch, job.arch["dtype"])
    ref = spec.reference(job.config["reference"]).Model(
        job.arch, job.seed, job.device, act=act)
    mm = _mm(low, act)
    k = ans["last"]
    x_fp = x_q = ref.embed(calib)
    vals: Dict[str, float] = {}

    def fp_lin(site, x, wt, b):
        return _bias(mm(x, wt), b)

    for j in range(k + 1):
        p, name = ref.layer(j), f"layers.{j}"
        with torch.no_grad():
            y_fp = _over_rows(lambda x: ref.block(p, x, fp_lin, name), x_fp)
        if j == 0:
            r0 = _Recon(ref, recipe, 0, x_q, y_fp, mm)
            gaps = [_gap(a, r0.step()) for a in ans["losses"][0]]
            vals.update(loss1_gap=gaps[0], loss23_gap=max(gaps[1:]))
            del r0
        wq = {f"{name}.{s}": quant.dequant(_codes(qt).float(), qt.scale.float(),
                                           qt.zero.float())
              for s, qt in ref.sites(ans["exported"][j]).items()}
        ast = {s: ans["astates"][s] for s in wq}
        if j == k:
            def eval_lin(site, x, wt, b):
                xq = quant.lsq_act(x.float(), ast[site], recipe.a_bits)
                return _bias(mm(xq.to(act), wq[site].to(act)), b)
            with torch.no_grad():
                y = _over_rows(lambda x: ref.block(p, x, eval_lin, name), x_q)
            vals["err_gap"] = _gap(ans["err_after"], _mse(y, y_fp))
            del y, wq
            rk = _Recon(ref, recipe, k, x_q, y_fp, mm)
            loss1 = rk.step()
            for _ in range(recipe.iters - 1):
                rk.step()
            vals.update(wloss1_gap=_gap(ans["losses"][1], loss1),
                        werr_gap=_gap(ans["err_after"], rk.error()))
            return vals

        def deploy_lin(site, x, wt, b):
            xq = quant.deploy_act(x.float(), ast[site], recipe.a_bits)
            return _bias(mm(xq, wq[site]).to(act), b)
        with torch.no_grad():
            x_q = _over_rows(lambda x: ref.block(p, x, deploy_lin, name), x_q)
        x_fp = y_fp
    raise AssertionError("unreachable: the window finished block k")


def numbers(job, recipe, calib: torch.Tensor, ans: Dict[str, Any],
            precision: str = "ref") -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (``job.limits``)."""
    vals = readings(job, recipe, calib, ans, precision)
    return {k: {"value": vals[k], "limit": v} for k, v in job.limits.items()}


def failed_blocks(checks: Dict[str, Dict[str, float]]) -> int:
    """Blocks whose check failed: block 0 (its first steps) and the last
    block (its steps, its export)."""
    bad = {n for n, c in checks.items() if not c["value"] <= c["limit"]}
    return int(bool(bad & {"loss1_gap", "loss23_gap"})) + int(
        bool(bad - {"loss1_gap", "loss23_gap"}))
