"""The PTQ job: ``repro_torch.core.reconstruct.quantize_blocks`` over a
model's blocks, as a user quantizes a model.

Set-up makes the weights and the calibration tokens from the seed and runs
the one ``quantize_blocks`` call through block 0, which builds and
captures the reconstruction engine. The window starts when block 0 ends
and holds whole blocks: the blocks are handed to the call one at a time,
and none is started that would end past ``--seconds`` (its duration taken
as the longest block's so far, plus 2%; in a traced run the time spent
starting the profiler and writing the trace does not count). The call
then returns with the blocks it finished.

``ptq_steps_per_s`` is the reconstruction steps of the window's blocks over
the window's time, which holds every block's teacher pass, observer, LSQ
initialisation, engine loop, export and student advance.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from bench import weights
from bench.harness import Job, Profile, annotate, now, telemetry

MARGIN = 1.02


class _Feed:
    """The blocks as ``quantize_blocks`` iterates them, cut where the next
    block would end past the window. ``progress`` (the call's callback)
    stamps each block's end once the device has finished it."""

    def __init__(self, blocks, seconds: float, sync, on_block=None):
        self.blocks, self.seconds, self.sync = blocks, seconds, sync
        self.on_block = on_block
        self.ends: List[float] = []     # each block's end
        self.resumed: List[float] = []  # when the callback handed back
        self.t_start: Optional[float] = None
        self.paused = 0.0  # the callback's own time (writing a trace)

    def __len__(self) -> int:
        return len(self.blocks)

    def __iter__(self):
        for i, block in enumerate(self.blocks):
            if i:
                durs = [b - a for a, b in zip(self.ends, self.ends[1:])]
                longest = max(durs + [self.ends[0] - self.t_begin])
                if now() + MARGIN * longest > self.t_start + self.paused \
                        + self.seconds:
                    return
            else:
                self.t_begin = now()
            yield block

    def progress(self, _msg: str) -> None:
        self.sync()
        t = now()
        self.ends.append(t)
        if self.t_start is None:
            self.t_start = t
        if self.on_block is not None:
            self.on_block(len(self.ends) - 1)
        self.resumed.append(now())
        self.paused += self.resumed[-1] - t


def _named(apply):
    """A block's ``apply`` whose passes, while the profiler runs, are named
    in the trace by their mode (fp teacher, calib, recon, deploy)."""
    def named(p, x, ctx):
        with annotate(f"bench.block.{ctx.mode}"):
            return apply(p, x, ctx)
    return named


def run(job: Job) -> Dict[str, Any]:
    """The timed run, then the comparison with the reference."""
    out, ctx = program(job)
    from bench.compare import ptq as compare
    checks = compare.numbers(job, *ctx)
    out.update(checks=checks, failed=compare.failed_blocks(checks))
    return out


def program(job: Job):
    """The program's run: (outcome, (recipe, calibration tokens, the
    program's answers)), the program's state freed."""
    import torch
    from repro_torch.configs import ArchConfig
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.core.reconstruct import quantize_blocks
    from repro_torch.models import build_model

    tr, arch, dev = job.traffic, job.arch, job.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:  # the port's CUDA sources, built once per checkout
        from repro_torch.kernels import build
        build.build()
    model = build_model(ArchConfig(**arch))
    params = weights.program_params(arch, job.seed, dev, head=False)
    calib = weights.zipf_tokens(job.seed, "calib", tr["calib_seqs"],
                                tr["seq_len"], arch["vocab"], tr["zipf"], dev)
    recipe = QuantRecipe(**tr["recipe"], seed=int(job.seed))
    x0, blocks, _ = model.quant_blocks(params, calib)
    for b in blocks:
        b.apply = _named(b.apply)
    prof = Profile() if job.trace else None

    def on_block(i: int) -> None:
        # the traced window is the first block after set-up; the trace is
        # written when it ends and read after the window
        if prof is not None and i == 0:
            prof.start()
        elif prof is not None and i == 1:
            prof.stop()

    feed = _Feed(blocks, job.seconds, sync, on_block)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with telemetry(job.trace) as sink:
        try:
            finalized, astates, reports = quantize_blocks(
                feed, recipe, x0, progress=feed.progress)
        finally:
            if prof is not None:
                prof.close()
    n_win = len(reports) - 1
    if n_win < 1:
        raise SystemExit(f"bench: no block fits a window of {job.seconds} s "
                         f"(block 0 took {feed.ends[0] - feed.t_begin:.1f} s)")
    t_end = feed.ends[-1]
    steps = sum(r.iters for r in reports[1:])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    # the spans' share of the window, read where the profiler was off: after
    # the traced block's callback handed back (the whole window untraced)
    first = 2 if prof is not None else 1
    clean = (feed.resumed[first - 1], t_end) if n_win >= first else None
    if prof is not None:
        prof.read()
    out = {
        "attempted": n_win,
        "e2e": {"ptq_steps_per_s": steps / (t_end - feed.t_start),
                "setup_s": feed.t_start - job.t0},
        "memory_peak_bytes": peak,
        "record": {
            "kind": "ptq", "workload": job.workload, "arch": arch, "traffic": tr,
            "window": (feed.t_start, t_end), "clean": clean,
            "clean_steps": sum(r.iters for r in reports[first:]),
            "spans": [] if sink is None else sink.spans,
            "trace": None if prof is None else prof.summary,
        },
    }
    # the program's answers, kept for the comparison; the rest is freed
    answers = {"losses": ([float(v) for v in reports[0].loss_curve[:3]],
                          float(reports[-1].loss_curve[0])),
               "err_after": float(reports[-1].err_after),
               "exported": finalized, "astates": astates,
               "last": len(reports) - 1}
    del params, blocks, x0, feed, model
    if cuda:
        torch.cuda.empty_cache()
    return out, (recipe, calib, answers)
