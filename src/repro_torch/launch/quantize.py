"""PTQ launcher of the port (the counterpart of ``repro/launch/quantize.py``):
load a trained checkpoint (or draw random weights), run block-wise FlexRound
(or any registered method), export integer weights, optionally serve them.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch smollm-135m \\
        --smoke --w-bits 4 --iters 2 --calib 8 --seq 16 --device cpu --serve

Mixed precision via per-site rules (glob over site names, last match wins):

    ... --w-bits 4 --rule 'layers.0.*:w_bits=8' --rule 'layers.29.*:w_bits=8'

The flags and defaults are the reference's. Runs on the card unless
``--device cpu`` is passed; ``--backend`` picks the deploy matmuls:
``auto`` (the hand-written kernels for CUDA tensors, their plain versions
for CPU tensors), ``kernel`` (the kernels; CUDA only) or ``torch`` (the plain
versions).

Automatic mixed precision (sensitivity-guided, ``repro_torch.allocate``):

    ... --auto-bits 4.5                   # numel-weighted average bits
    ... --auto-bits 150000 --budget bytes # serving-bytes budget

probes every site at candidate bit-widths on the calibration set (the
probe's bodies captured once per apply_key and bit width on the card),
solves the budget and appends the emitted per-site rules to the recipe —
probe, solve and quantize in one invocation. The allocation is persisted to
--resume-dir (allocation.json) and stamped into every per-block checkpoint;
a resume reuses the recorded allocation, and a resume under another budget
or objective fails loudly.

Fault tolerance: per-block PTQ checkpoints (``--resume-dir``). A killed run
resumes at the first unfinished block and finishes with the results of a run
without a break, bit for bit; resuming under different rules fails loudly
(per-site plans are recorded in the checkpoint).

``--profile`` writes a perfetto-loadable Chrome trace of the whole run
(``torch.profiler``, CPU and CUDA activity; each recon chunk, serve prefill
and decode step annotated) into ``<--telemetry DIR or $TMPDIR/repro_profile>
/profile``. ``--serve`` serves through CUDA graphs on the card (one per
prefill bucket and one for decode) and runs the same bodies directly on the
CPU.

The reconstruction replays one CUDA graph per engine on the card (the
step of each group of identical blocks captured once, ``core.reconstruct``)
and runs the same step directly on the CPU; ``--scan-chunk N`` sets the
steps between the host's syncs (one ``recon.chunk`` span each). After the
run the launcher prints the engine's counters as the reference does
(``compiles: step=... (total ...)``; ``step`` counts the captures,
``probe`` the allocator's probe bodies).

Data-parallel calibration (``--mesh debug|production``, ``--multi-pod``):
one process per rank, started by ``torchrun``, e.g. the debug mesh's 8
ranks on one card (gloo) or on the CPU (add ``--device cpu``):

    python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.quantize --arch smollm-135m --mesh debug ...

A world size other than the mesh's exits before any work, naming the ranks
it needs. Each rank fetches only its data-parallel shard of the
calibration set and the ranks assemble the global set from the shards
(``data.assemble_global_batch``: the reference's per-host calibration);
the reconstruction and the allocator's probe split the streams over the
data axes (``core.reconstruct``). Global rank 0 alone writes the export
and the allocation, prints the report and serves; the other ranks wait for
it at a barrier. Each rank's telemetry file and profile carry its rank.

``--analyze``/``--analyze-mem`` run quantlint
(``repro_torch.analysis.lint.run_analysis``, with memcheck for the
latter) on the launcher's device after the run, print the report and exit
non-zero on an error finding; on the CPU that includes QL304's
``needs-card`` (the kernel differ needs the card). Under ``--mesh`` every
rank traces (the sharded recon entry joins) and rank 0 prints. An encdec
arch (whisper-medium) exits before any work: its calibration needs frame
embeddings the launcher cannot draw (the reference's launcher fails on it
as well); its entry points are the library's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, PTQCheckpointer, save_pytree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import QuantRecipe, method_api
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import tree_weight_bytes
from repro_torch.core.reconstruct import (DEFAULT_CHUNK, engine_stats,
                                          quantize_blocks, reset_engine_stats,
                                          site_plans)
from repro_torch.data import (CalibrationSet, StragglerPolicy,
                              SyntheticTokens, assemble_global_batch)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as meshes
from repro_torch.models.model import build_model
from repro_torch.obs import profiler
from repro_torch.obs.sink import (JsonlSink, RunManifest, current_manifest,
                                  rank_file)
from repro_torch.obs.telemetry import TELEMETRY, Stopwatch, block_on
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.smoke import serve_capability


def _at_least_one(text: str) -> int:
    n = int(text)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{n} is not >= 1")
    return n


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quantize")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--method", default="flexround",
                    choices=list(method_api.available_methods()))
    ap.add_argument("--setting", default="qdrop", choices=["brecq", "qdrop"])
    ap.add_argument("--recon", default="block", choices=["block", "layer"])
    ap.add_argument("--w-bits", type=int, default=8)
    ap.add_argument("--a-bits", type=int, default=None)
    ap.add_argument("--w-granularity", default="per_channel")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="GLOB:K=V[,K=V...]",
                    help="per-site override, e.g. 'layers.0.*:w_bits=8'; "
                         "repeatable, later rules win")
    ap.add_argument("--calib", type=int, default=64)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--from-ckpt", default=None,
                    help="CheckpointManager dir (the port's format) of a "
                         "trained model; its state holds 'params'")
    ap.add_argument("--resume-dir", default=None,
                    help="per-block PTQ checkpoints: a killed run resumes "
                         "at its first unfinished block")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda; cpu runs the plain versions on the "
                         "CPU")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "torch"],
                    help="deploy-mode matmuls: auto = the CUDA kernels for "
                         "CUDA tensors, the plain versions for CPU tensors; "
                         "kernel = the CUDA kernels; torch = the plain "
                         "versions")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="after quantization, time a short deploy-mode "
                         "decode and report us/step + weight bytes moved")
    ap.add_argument("--serve", action="store_true",
                    help="after quantization, serve a synthetic request "
                         "stream through the scheduler and the slot engine "
                         "(int8 KV) and report tokens/s, HBM/slot, latency "
                         "percentiles")
    ap.add_argument("--serve-slots", type=int, default=4,
                    help="decode slots for --serve")
    ap.add_argument("--serve-requests", type=int, default=8,
                    help="synthetic request count for --serve")
    ap.add_argument("--serve-max-new", type=int, default=16,
                    help="tokens generated per request for --serve")
    ap.add_argument("--no-kv-quant", action="store_true",
                    help="serve with the fp KV cache instead of the int8 "
                         "default")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="enable telemetry (repro_torch.obs): spans, "
                         "counters and histograms stream to "
                         "DIR/events.jsonl as manifest-stamped JSONL")
    ap.add_argument("--scan-chunk", type=_at_least_one, default=DEFAULT_CHUNK,
                    help="reconstruction steps between host syncs (the "
                         "reference's steps per fused dispatch); >= 1")
    ap.add_argument("--analyze", action="store_true",
                    help="after the run, the quantlint report "
                         "(repro_torch.analysis.lint); exits non-zero on an "
                         "error finding")
    ap.add_argument("--analyze-mem", action="store_true",
                    help="--analyze with memcheck (QL4xx)")
    ap.add_argument("--auto-bits", type=float, default=None, metavar="VALUE",
                    help="automatic mixed precision: probe per-site "
                         "sensitivity and allocate bit-widths to meet this "
                         "budget (interpreted per --budget); emitted rules "
                         "are appended to the recipe")
    ap.add_argument("--budget", default="avg_bits",
                    choices=["avg_bits", "bytes"],
                    help="meaning of --auto-bits: numel-weighted average "
                         "bits, or total serving bytes (packed codes + "
                         "affine grid)")
    ap.add_argument("--alloc-objective", default="combined",
                    choices=["mse", "fisher", "combined"],
                    help="sensitivity metric the allocator minimizes")
    ap.add_argument("--mesh", default=None, choices=["debug", "production"],
                    help="data-parallel calibration over a mesh of torchrun "
                         "ranks: debug (2, 4) = 8 ranks, production (16, "
                         "16) = 256")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh: the pod x data x model mesh, debug "
                         "(2, 2, 2), production (2, 16, 16)")
    ap.add_argument("--profile", action="store_true",
                    help="wrap the run in torch.profiler, writing a "
                         "perfetto-loadable Chrome trace under --telemetry "
                         "DIR (or $TMPDIR/repro_profile)/profile")
    return ap


def _reject_unported(args) -> None:
    """Exit (non-zero) on an encoder-decoder arch, whose frames the
    launcher has no source for, and on flags that cannot combine; never
    ignore one silently."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit(
            f"repro_torch.launch.quantize: --arch {args.arch}: the encdec "
            "family calibrates on (tokens, frames) pairs and the launcher has "
            "no source of frame embeddings (the reference's launcher fails "
            "here too: repro/launch/quantize.py:189 calls quant_blocks "
            "without frames); quantize it through the library: "
            "build_model(cfg).quant_blocks(params, tokens, frames), then "
            "quantize_blocks (ROADMAP Queue 3)")
    if args.multi_pod and args.mesh is None:
        raise SystemExit("repro_torch.launch.quantize: --multi-pod shapes "
                         "the --mesh; pass --mesh debug or --mesh production")


@dataclasses.dataclass
class LaunchResult:
    """What one launcher run produced (returned by ``main``/``run``)."""
    cfg: Any
    model: Any
    qparams: Any
    astates: Dict[str, Any]
    recipe: QuantRecipe
    reports: List[Any]
    resumed_units: int
    out: str
    serve: Optional[Dict[str, Any]] = None
    serve_smoke_us: Optional[float] = None
    allocation: Optional[dict] = None  # report.meta() of an --auto-bits run


def _rule_text(rule) -> str:
    """The canonical ``--rule`` form, so the export's metadata round-trips."""
    return rule.pattern + ":" + ",".join(f"{k}={v}" for k, v in rule.overrides)


def build_recipe(args) -> QuantRecipe:
    """The run's recipe from the parsed flags (minibatches of
    ``min(16, --calib)``, as the reference's launcher)."""
    return QuantRecipe(method=args.method, setting=args.setting,
                       recon=args.recon, w_bits=args.w_bits,
                       w_granularity=args.w_granularity, a_bits=args.a_bits,
                       iters=args.iters, lr=args.lr,
                       batch_size=min(16, args.calib), rules=tuple(args.rule))


def build_mesh(kind: str, *, multi_pod: bool = False, device=None):
    """``--mesh`` -> (DeviceMesh, this rank's device): checks the world size
    ``torchrun`` gave before any work, then starts the process group
    (``launch.mesh.init_distributed``) and builds the mesh."""
    shape, axes = meshes.mesh_layout(kind, multi_pod=multi_pod)
    need = meshes.ranks_needed(kind, multi_pod=multi_pod)
    have = int(os.environ.get("WORLD_SIZE", "1"))
    if have != need:
        flags = f"--mesh {kind}" + (" --multi-pod" if multi_pod else "")
        raise SystemExit(
            f"repro_torch.launch.quantize: {flags} is a {shape} "
            f"{'x'.join(axes)} mesh of {need} ranks, but this run has a "
            f"world size of {have}; start {need} ranks with torchrun: python "
            f"-m torch.distributed.run --nproc-per-node {need} -m "
            f"repro_torch.launch.quantize {flags} ... (add --device cpu for "
            "CPU ranks)")
    dev = meshes.init_distributed(resolve_device(device))
    mesh = meshes.make_debug_mesh(multi_pod=multi_pod, device_type=dev.type) \
        if kind == "debug" else meshes.make_production_mesh(
            multi_pod=multi_pod, device_type=dev.type)
    return mesh, dev


def build_sharded_calibration(src, n_calib: int, mesh, device):
    """Per-rank calibration for a mesh run: this rank fetches only its
    data-parallel shard (``SyntheticTokens.batch`` of step 10,000, as
    ``CalibrationSet.build_sharded``); the ranks exchange the shards and
    assemble the global set through the straggler policy. Returns
    (CalibrationSet, (N,) sample weight, or None when every shard came: an
    all-ones weight only changes the reduction)."""
    dp = meshes.DataParallel.of(mesh)
    if n_calib % dp.size:
        raise SystemExit(
            f"repro_torch.launch.quantize: --calib {n_calib} does not divide "
            f"over the mesh's {dp.size} data-parallel ranks; pick a multiple "
            f"of {dp.size}")
    per = n_calib // dp.size
    mine = src.batch(10_000, n_calib, host=dp.rank, n_hosts=dp.size)
    full = {k: dp.gather_rows(v.to(device), n_calib).cpu()
            for k, v in mine.items()}
    shards = [{k: v[h * per:(h + 1) * per].numpy() for k, v in full.items()}
              for h in range(dp.size)]
    batch, weight = assemble_global_batch(shards, StragglerPolicy())
    cal = CalibrationSet(tokens=batch["tokens"])
    if meshes.is_writer():
        print(f"calibration: {n_calib} samples assembled from {dp.size} "
              f"per-rank shards (dp axes {meshes.dp_axes(mesh)}, weight mass "
              f"{float(weight.sum()):.0f}/{len(cal)})")
    return cal, (None if float(weight.sum()) == len(cal) else weight)


def run(args, params=None, calib_tokens=None) -> LaunchResult:
    """The launcher behind ``main``. ``params`` (a parameter tree) and
    ``calib_tokens`` ((N, S) ints) replace the drawn weights and the
    synthetic calibration set when given (the tests pass the reference's).
    With ``--mesh`` it starts the process group and destroys it on the way
    out."""
    mesh = None
    if args.mesh is not None:
        mesh, dev = build_mesh(args.mesh, multi_pod=args.multi_pod,
                               device=args.device)
    else:
        dev = resolve_device(args.device)
    try:
        result = _launch(args, params, calib_tokens, dev, mesh)
        if args.analyze or args.analyze_mem:
            analyze(dev, mem=args.analyze_mem)
        return result
    finally:
        if mesh is not None:
            meshes.shutdown()


def analyze(dev, *, mem: bool = False) -> None:
    """``--analyze``/``--analyze-mem``: the quantlint report on ``dev``
    (every rank of a mesh traces; rank 0 prints); exits non-zero on an
    error finding."""
    from repro_torch.analysis.lint import run_analysis
    writer = meshes.is_writer()
    rep = run_analysis(mem=mem, device=dev,
                       log=print if writer else (lambda *a, **k: None))
    if writer:
        print(rep.pretty())
    if rep.exit_code():
        raise SystemExit("quantlint: error findings (see above)")


def _launch(args, params, calib_tokens, dev, mesh) -> LaunchResult:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if params is None and args.from_ckpt:
        state, _ = CheckpointManager(args.from_ckpt).restore(device=dev)
        if state is None:
            raise SystemExit(f"--from-ckpt {args.from_ckpt}: no checkpoint")
        params = state["params"]
    elif params is None:
        if meshes.is_writer():
            print("no --from-ckpt: quantizing randomly-initialized weights "
                  "(structure demo)")
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)

    recipe = build_recipe(args)
    sample_weight = None
    if calib_tokens is None:
        src = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq, seed=0)
        if mesh is not None:
            cal, sample_weight = build_sharded_calibration(
                src, args.calib, mesh, dev)
            calib_tokens = cal.tokens
        else:
            calib_tokens = CalibrationSet.build(src, args.calib).tokens
    calib_tokens = torch.as_tensor(calib_tokens).to(dev)

    if args.telemetry:
        manifest = RunManifest.collect(
            backend=args.backend, device=dev, recipe=recipe,
            mesh=None if mesh is None else ",".join(
                f"{n}={s}" for n, s in zip(mesh.mesh_dim_names, mesh.shape)))
        events = rank_file(os.path.join(args.telemetry, "events.jsonl"))
        TELEMETRY.enable(sink=JsonlSink(events), manifest=manifest)
        print(f"telemetry: streaming to {events} "
              f"(git {manifest.git_sha}, schema {manifest.schema_version})")
    profiling = args.profile and profiler.start(os.path.join(
        args.telemetry or os.path.join(tempfile.gettempdir(), "repro_profile"),
        "profile"))
    try:
        result = _quantize_and_serve(args, cfg, model, params, recipe,
                                     calib_tokens, dev, mesh, sample_weight)
        if TELEMETRY.enabled:
            TELEMETRY.emit({"kind": "snapshot", **TELEMETRY.snapshot()})
    finally:
        if profiling:
            print(f"profile: Chrome trace written to {profiler.stop()}")
        if args.telemetry:
            TELEMETRY.disable()
    return result


def _quantize_and_serve(args, cfg, model, params, recipe, calib_tokens,
                        dev, mesh=None, sample_weight=None) -> LaunchResult:
    writer = meshes.is_writer()
    say = print if writer else (lambda *a, **k: None)
    x0, blocks, assemble = model.quant_blocks(params, calib_tokens)
    reset_engine_stats()
    alloc_meta = None
    if args.auto_bits is not None:
        recipe, alloc_meta = apply_auto_bits(
            blocks, recipe, x0, value=args.auto_bits, budget=args.budget,
            objective=args.alloc_objective, resume_dir=args.resume_dir,
            mesh=mesh)
        TELEMETRY.emit({"kind": "allocation", "digest": alloc_meta["digest"],
                        "name": alloc_meta["name"]})
    if recipe.rules and writer:
        overridden = [(n, p.summary()) for b in blocks
                      for n, p in site_plans(b, recipe).items()
                      if recipe.overrides_for(n)]
        print(f"rules override {len(overridden)} site(s):")
        for n, s in overridden:
            print(f"  {n}: {s}")
    resumed = 0
    if args.resume_dir is not None:
        saved = PTQCheckpointer(args.resume_dir).meta()
        resumed = 0 if saved is None else len(saved["reports"])
    finalized, astates, reports = quantize_blocks(
        blocks, recipe, x0, checkpoint_dir=args.resume_dir,
        progress=lambda s: say(s, flush=True), chunk=args.scan_chunk,
        allocation=alloc_meta, mesh=mesh, sample_weight=sample_weight)
    qparams = assemble(finalized)

    ran = reports[resumed:]  # units reconstructed by this process
    steps = sum(r.iters for r in ran)
    loop_s = sum(r.iters / r.steps_per_s for r in ran if r.steps_per_s > 0)
    st = engine_stats()
    say(f"recon: {steps} steps over {len(ran)} unit(s) in {loop_s:.2f}s "
          f"({steps / max(loop_s, 1e-9):.1f} steps/s); {resumed} unit(s) "
          f"resumed from the checkpoint; compiles: step={st.step_compiles} "
          f"teacher={st.teacher_compiles} student={st.student_compiles} "
          f"recon_err={st.recon_error_compiles} "
          f"schedule={st.schedule_compiles} probe={st.probe_compiles} "
          f"(total {st.compile_count}); engines {st.engine_builds} built, "
          f"{st.engine_hits} reused", flush=True)

    out = args.out or os.path.join(tempfile.gettempdir(),
                                   f"quantized_{cfg.name}_{args.method}")
    result = LaunchResult(cfg=cfg, model=model, qparams=qparams,
                          astates=astates, recipe=recipe, reports=reports,
                          resumed_units=resumed, out=out,
                          allocation=alloc_meta)
    if writer:  # rank 0 alone exports and serves; the others wait
        _export_and_serve(args, cfg, model, blocks, recipe, reports, result,
                          dev)
    meshes.barrier()
    return result


def _export_and_serve(args, cfg, model, blocks, recipe, reports, result,
                      dev) -> None:
    qparams, astates, out = result.qparams, result.astates, result.out
    save_pytree(out, {"params": qparams, "astates": astates},
                {"arch": cfg.name, "method": args.method,
                 "w_bits": args.w_bits, "a_bits": args.a_bits,
                 "rules": [_rule_text(r) for r in recipe.rules],
                 "manifest": current_manifest().to_dict()})
    tot0 = sum(r.err_before for r in reports)
    tot1 = sum(r.err_after for r in reports)
    print(f"quantized {len(blocks)} blocks: recon err {tot0:.3e} -> "
          f"{tot1:.3e}; saved to {out}")
    if args.serve_smoke:
        result.serve_smoke_us = serve_smoke(
            model, qparams, astates, recipe, cfg, backend=args.backend,
            device=dev)
    if args.serve:
        result.serve = serve_engine_run(
            model, qparams, astates, recipe, cfg, backend=args.backend,
            slots=args.serve_slots, requests=args.serve_requests,
            max_new=args.serve_max_new, kv_quant=not args.no_kv_quant,
            device=dev)


def apply_auto_bits(blocks, recipe, x0, *, value: float, budget: str,
                    objective: str = "combined", resume_dir=None, mesh=None):
    """Probe -> solve -> append emitted rules. Returns (recipe, alloc_meta).

    When ``resume_dir`` holds an ``allocation.json`` from an earlier run the
    recorded allocation is validated against the requested budget and reused
    (no re-probe) so the resumed run quantizes under the identical rules;
    a different budget fails loudly. Under a ``mesh`` every rank probes its
    rows and gets the same allocation; rank 0 alone writes and prints it.
    """
    from repro_torch.allocate import AllocationReport, Budget, auto_allocate

    kind = "weight_bytes" if budget == "bytes" else budget
    report = None
    if resume_dir is not None:
        report = AllocationReport.load(resume_dir)
    if report is not None:
        want = {"kind": kind, "value": value}
        if report.budget != want or report.objective != objective:
            raise ValueError(
                f"resume dir {resume_dir} holds allocation "
                f"{report.name!r} for budget {report.budget} / objective "
                f"{report.objective!r} but this run requests {want} / "
                f"{objective!r}; re-run with the original settings or a "
                "fresh checkpoint dir")
        have = {n for b in blocks for n in b.sites}
        stale = sorted(set(report.bits()) - have)
        if stale:
            raise ValueError(
                f"resume dir {resume_dir} holds allocation {report.name!r} "
                f"for sites this model does not have (e.g. {stale[:3]}); "
                "its rules would silently match nothing — re-probe with a "
                "fresh checkpoint dir")
        if meshes.is_writer():
            print(f"reusing recorded allocation from {resume_dir}:")
    else:
        report = auto_allocate(blocks, recipe, x0, Budget(kind, value),
                               objective=objective, mesh=mesh)
        if resume_dir is not None and meshes.is_writer():
            report.save(resume_dir)
        meshes.barrier()
    if meshes.is_writer():
        print(report.pretty(), flush=True)
    return recipe.with_rules(*report.rules()), report.meta()


@torch.no_grad()
def serve_smoke(model, qparams, astates, recipe, cfg, *, backend: str = "auto",
                device: DeviceLike = None, batch: int = 2,
                prompt_len: int = 16, steps: int = 8) -> float:
    """Short deploy-mode decode: prefill a tiny batch, then time ``steps``
    greedy decode steps (the device synchronized at the end). Returns
    us/step (also printed, with the weight bytes each step moves)."""
    ok, reason = serve_capability(model)
    if not ok:
        print(f"serve-smoke: skipped arch={cfg.name} reason={reason}")
        return float("nan")
    dev = resolve_device(device)
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                   backend=backend)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    cache = model.init_cache(batch, prompt_len + steps + 1, device=dev)
    _, cache = model.prefill(qparams, tokens, cache, ctx)
    tok = tokens[:, -1:]
    logits, cache = model.decode_step(qparams, tok, cache, prompt_len,
                                      ctx)  # warm
    block_on(logits)
    sw = Stopwatch()
    for i in range(steps):
        logits, cache = model.decode_step(qparams, tok, cache,
                                          prompt_len + 1 + i, ctx)
    block_on(logits)
    us = sw.elapsed_us() / steps
    wbytes = tree_weight_bytes(qparams)
    print(f"serve-smoke[{backend}]: {us:.1f} us/step, "
          f"weight bytes/step {wbytes / 2**20:.2f} MiB")
    return us


def serve_engine_run(model, qparams, astates, recipe, cfg, *,
                     backend: str = "auto", slots: int = 4,
                     requests: int = 8, max_new: int = 16,
                     kv_quant: bool = True, device: DeviceLike = None
                     ) -> Optional[Dict[str, Any]]:
    """Serve a synthetic request stream (the reference's: prompts of 4-15
    tokens from ``np.random.default_rng(0)``) through the ``Scheduler`` and
    the slot engine, deploy-mode weights, int8 KV cache by default. Prints
    tokens/s, HBM per slot, per-bucket prefill latency and per-request
    TTFT/queue-wait percentiles. Returns {"requests", "outputs", "stats",
    "seconds"}, or None (with a machine-readable reason printed) for a
    family the slot layout cannot serve."""
    ok, reason = serve_capability(model, engine=True, kv_quant=kv_quant)
    if not ok:
        print(f"serve: skipped arch={cfg.name} reason={reason}")
        return None
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                   backend=backend)
    max_len = max(32, 2 * max_new)
    engine = ServeEngine(model, qparams, ctx,
                         EngineConfig(slots=slots, max_len=max_len,
                                      prefill_group=2, kv_quant=kv_quant),
                         device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(4, 16)),
                                        ).astype(np.int32),
                    max_new=max_new)
            for i in range(requests)]
    sw = Stopwatch()
    with Scheduler(engine) as sched:
        outs = sched.run(reqs)
        st = sched.stats()
    dt = sw.elapsed_s()
    n_tok = sum(len(v) for v in outs.values())
    pf = " ".join(f"b{b}={s['p50']:.0f}us(n={s['count']})"
                  for b, s in sorted(st["prefill_us"].items()))
    rq = st["requests"]
    print(f"serve[{backend}] kv={'int8' if kv_quant else 'fp'}: "
          f"{requests} requests x {max_new} tokens on {slots} slots -> "
          f"{n_tok / dt:.1f} tokens/s, "
          f"hbm_per_slot {st['hbm_per_slot_MiB']:.4f} MiB, "
          f"compile_count {st['compile_count']} "
          f"(buckets {st['buckets']}), compile_us "
          f"{ {k: round(v) for k, v in st['compile_us'].items()} }, "
          f"prefill {pf}")
    print(f"serve requests: ttft p50={rq['ttft_us']['p50']:.0f}us "
          f"p95={rq['ttft_us']['p95']:.0f}us, "
          f"queue_wait p50={rq['queue_wait_us']['p50']:.0f}us "
          f"p95={rq['queue_wait_us']['p95']:.0f}us, "
          f"detok_errors={rq['detok_errors']}")
    return {"requests": reqs, "outputs": dict(outs), "stats": st,
            "seconds": dt}


def main(argv: Optional[List[str]] = None) -> LaunchResult:
    args = build_parser().parse_args(argv)
    _reject_unported(args)
    return run(args)


if __name__ == "__main__":
    main()
