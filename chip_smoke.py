#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is non-zero and the last line
is not printed):

1. Device   — require CUDA; print the card's name and power limit.
2. Build    — compile every CUDA source under src/repro_torch/csrc with
              nvcc (one process per source, in parallel); print the seconds
              and the compiler's register/shared-memory report.
3. Kernels  — hold K1 (dequant_matmul_w4), K2 (dequant_matmul_w8) and K3
              (qmatmul_int8) against their plain PyTorch versions on the card
              at the main-path shapes of smollm-135m (M in {4, 64, 512}, every
              site's (K, N)), plus ragged M, N and K, x in bfloat16 and
              float32; K3's int32 accumulator must be exact. Time kernel,
              plain version and library yardstick with CUDA events.
4. Path     — smollm-135m at full width in bfloat16, weights from
              torch.Generator seed 0: export-only FlexRound PTQ (W4 body, W8
              layers 0 and 29, A8, per-channel) on 8 x 64 calibration tokens,
              then the serving engine (4 slots, max_len 32, int8 KV cache)
              answers 8 requests of 16 new tokens. The launch counters are
              zeroed just before and read just after; every kernel must have
              launched. One request is re-run with the plain versions
              (backend "torch") and must agree within bfloat16 tolerance.

The line before the last is the JSON kernel summary; the last line is
``{"ok": true, "device": {...}}``. A per-shape table goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
L2_BYTES = 50 * 2**20

SMOLLM_SITES = {  # (K, N) of every quantized site of one layer
    "wq": (576, 576), "wk": (576, 192), "wv": (576, 192), "wo": (576, 576),
    "w_gate": (576, 1536), "w_up": (576, 1536), "w_down": (1536, 576),
}
TIMED = {  # the shape each kernel's summary line reports
    "dequant_matmul_w4": (4, 576, 1536, "bfloat16"),   # decode, w_gate/w_up
    "dequant_matmul_w8": (4, 576, 1536, "bfloat16"),   # decode, layers 0, 29
    "qmatmul_int8": (512, 576, 1536, "int8"),          # export pass, W8A8
}
SOURCES = {
    "dequant_matmul_w4": ("src/repro_torch/csrc/dequant_matmul.cu",
                          "src/repro/kernels/dequant_matmul_w4.py:135"),
    "dequant_matmul_w8": ("src/repro_torch/csrc/dequant_matmul.cu",
                          "src/repro/kernels/dequant_matmul_w4.py:144"),
    "qmatmul_int8": ("src/repro_torch/csrc/qmatmul_int8.cu",
                     "src/repro/kernels/qmatmul_int8.py:58"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ timing
def cuda_ms(torch, fn, arg_sets, reps: int = 5) -> float:
    """Device ms per call: the calls over ``arg_sets`` (one weight copy each,
    together larger than L2, so weights come from device memory as in a
    decode step) are captured once in a CUDA graph and the graph is replayed
    between CUDA events, so the host's per-call overhead is not counted."""
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def eager_ms(torch, fn, arg_sets) -> float:
    """Wall ms per call issued one by one from Python (host overhead
    included), over the same calls."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in arg_sets:
        fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(arg_sets)


def _copies(wbytes: int) -> int:
    """Weight copies whose sum exceeds twice the L2 (at least 64 calls)."""
    return min(256, max(64, math.ceil(2 * L2_BYTES / wbytes)))


def bound(M: int, K: int, N: int, in_type: str, byte_count: int):
    """Least time (ms) for the work: bytes over the memory rate vs ops over
    the peak rate for the input type; returns (ms, "bytes"|"operations")."""
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N / PEAK_OPS[in_type]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- kernels
def check_dequant(torch, kern, ref, name, M, K, N, dtype, gen, timed):
    packed = name == "dequant_matmul_w4"
    bits = 4 if packed else 8
    x = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
    rows = K // 2 if packed else K
    codes = torch.randint(0, 256 if packed else 2**bits, (rows, N),
                          generator=gen, device=DEV, dtype=torch.uint8)
    scale = (torch.exp(torch.randn((1, N), generator=gen, device=DEV) * 0.2)
             * 0.2 / (2**bits - 1))
    zero = torch.round(torch.rand((1, N), generator=gen, device=DEV)
                       * (2**bits - 1))
    fn = getattr(kern, name)
    plain = getattr(ref, f"{name}_ref")
    got = fn(x, codes, scale, zero)
    want = plain(x, codes, scale, zero)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != (M, N) or not torch.isfinite(got).all():
        fail(f"{name} {M}x{K}x{N} {dtype}: bad output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        # both round a float32 sum to bfloat16: at most one bf16 step apart
        tol = 2e-2 + 2e-2 * want.float().abs()
    else:
        # two float32 sums of K products in different orders: a few
        # sqrt(K) roundings of the sum of |terms| (the kernel accumulates
        # sequentially per thread, cuBLAS in blocks)
        w = scale * ((ref.unpack_f32(codes) if packed else codes.float()) - zero)
        tol = 1e-5 + 8 * math.sqrt(K) * 2.0**-24 * (x.abs() @ w.abs())
    if not bool((err <= tol).all()):
        fail(f"{name} {M}x{K}x{N} {dtype}: max |err| {err.max().item():.3e} "
             f"beyond the stated tolerance")
    row = {"kernel": name, "M": M, "K": K, "N": N,
           "x": str(dtype).replace("torch.", ""),
           "max_abs_err": err.max().item()}
    if timed:
        wbytes = codes.numel() + 8 * N
        sets = [(x, codes.clone(), scale, zero) for _ in range(_copies(wbytes))]
        # yardstick: one cuBLAS product with the weight already dequantized
        wdeq = [(x, (scale * ((ref.unpack_f32(c) if packed else c.float())
                              - zero)).to(dtype)) for _, c, _, _ in sets]
        row["ms"] = cuda_ms(torch, fn, sets)
        row["eager_ms"] = eager_ms(torch, fn, sets)
        row["plain_ms"] = cuda_ms(torch, plain, sets)
        row["library_ms"] = cuda_ms(torch, torch.matmul, wdeq)
        in_type = row["x"]
        nbytes = x.numel() * x.element_size() + wbytes + M * N * x.element_size()
        row["bound_ms"], row["bound_by"] = bound(M, K, N, in_type, nbytes)
        del wdeq, sets
    return row


def check_int8(torch, kern, ref, M, K, N, gen, timed):
    a_q = torch.randint(-128, 128, (M, K), generator=gen, device=DEV,
                        dtype=torch.int8)
    b_q = torch.randint(-128, 128, (K, N), generator=gen, device=DEV,
                        dtype=torch.int8)
    a_scale = torch.tensor(0.021, device=DEV)
    a_zero = torch.tensor(7.0 - 128.0, device=DEV)
    b_scale = (torch.exp(torch.randn((1, N), generator=gen, device=DEV) * 0.2)
               * 0.2 / 255)
    b_zero = torch.round(torch.rand((1, N), generator=gen, device=DEV) * 255) - 128
    # exact accumulator: unit scales and zero offsets make out == f32(acc)
    one, nil = torch.ones((), device=DEV), torch.zeros((), device=DEV)
    acc = kern.qmatmul_int8(a_q, b_q, one, nil, torch.ones((1, N), device=DEV),
                            torch.zeros((1, N), device=DEV))
    exact = torch.matmul(a_q.double(), b_q.double()).float()
    torch.cuda.synchronize()
    if not torch.equal(acc, exact):
        fail(f"qmatmul_int8 {M}x{K}x{N}: int32 accumulator is not exact "
             f"({(acc - exact).abs().max().item()})")
    got = kern.qmatmul_int8(a_q, b_q, a_scale, a_zero, b_scale, b_zero)
    want = ref.qmatmul_int8_ref(a_q, b_q, a_scale, a_zero, b_scale, b_zero)
    torch.cuda.synchronize()
    # the kernel's epilogue associates as the Pallas kernel, the plain
    # version as ref.py: each rounds ~5 times at the size of its largest term
    cs = b_q.double().sum(0, keepdim=True)
    rs = a_q.double().sum(1, keepdim=True)
    az, bz = a_zero.double(), b_zero.double()
    terms = exact.double().abs() + (az * cs).abs() + (rs * bz).abs() + (K * az * bz).abs()
    tol = 16 * 2.0**-24 * (a_scale.double() * b_scale.double()).abs() * terms
    err = (got.double() - want.double()).abs()
    if got.shape != (M, N) or not bool((err <= tol).all()):
        fail(f"qmatmul_int8 {M}x{K}x{N}: max |err| {err.max().item():.3e} "
             f"beyond the epilogue rounding bound")
    row = {"kernel": "qmatmul_int8", "M": M, "K": K, "N": N, "x": "int8",
           "max_abs_err": err.max().item()}
    if timed:
        wbytes = b_q.numel() + 8 * N
        sets = [(a_q, b_q.clone(), a_scale, a_zero, b_scale, b_zero)
                for _ in range(_copies(wbytes))]
        row["ms"] = cuda_ms(torch, kern.qmatmul_int8, sets)
        row["eager_ms"] = eager_ms(torch, kern.qmatmul_int8, sets)
        row["plain_ms"] = cuda_ms(torch, ref.qmatmul_int8_ref, sets)
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            row["library_ms"] = cuda_ms(torch, torch._int_mm,
                                        [(s[0], s[1]) for s in sets])
        else:
            row["library_ms"] = None  # torch._int_mm needs M > 16
        nbytes = a_q.numel() + wbytes + 8 + 4 * M * N
        row["bound_ms"], row["bound_by"] = bound(M, K, N, "int8", nbytes)
        del sets
    return row


def kernels_phase(torch):
    from repro_torch.kernels import dequant_matmul_w4 as k12
    from repro_torch.kernels import qmatmul_int8 as k3
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    shapes = sorted(set(SMOLLM_SITES.values()))
    for M in (4, 64, 512):
        for K, N in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                timed = dtype == torch.bfloat16
                for name in ("dequant_matmul_w4", "dequant_matmul_w8"):
                    rows.append(check_dequant(torch, k12, ref, name, M, K, N,
                                              dtype, gen, timed))
            rows.append(check_int8(torch, k3, ref, M, K, N, gen, timed=True))
    for dtype in (torch.bfloat16, torch.float32):  # ragged M, N and K tiles
        rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w4", 7, 578,
                                  200, dtype, gen, False))
        rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w8", 7, 577,
                                  200, dtype, gen, False))
    rows.append(check_int8(torch, k3, ref, 7, 577, 200, gen, timed=False))
    for r in rows:
        if "ms" in r:
            log(f"  {r['kernel']:18s} M={r['M']:4d} K={r['K']:5d} N={r['N']:5d} "
                f"x={r['x']:8s} ms={r['ms']:.5f} eager_ms={r['eager_ms']:.5f} "
                f"plain_ms={r['plain_ms']:.5f} "
                f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e}")
    log(f"kernels: {len(rows)} comparisons passed")
    return rows


# -------------------------------------------------------------------- path
def serve_all(engine, requests):
    """Admit FIFO into free slots (up to the prefill group) and step until
    every request is done. Returns ({rid: tokens}, prefill seconds, decode
    seconds); both calls end in a host sync, so their wall time is real."""
    backlog, out = list(requests), {}
    prefill_s = decode_s = 0.0
    while backlog or engine.active:
        n = min(engine.cfg.prefill_group, len(engine.free_slots()), len(backlog))
        if n:
            t0 = time.perf_counter()
            for rid, tok in engine.admit(backlog[:n]):
                out.setdefault(rid, []).append(tok)
            prefill_s += time.perf_counter() - t0
            backlog = backlog[n:]
        if engine.active:
            t0 = time.perf_counter()
            for rid, tok in engine.step():
                out[rid].append(tok)
            decode_s += time.perf_counter() - t0
    engine.drain_finished()
    return out, prefill_s, decode_s


def forced_logits(torch, model, params, ctx, prompt, generated, max_len):
    """Logits along a fixed token path: prefill of the bucket-padded prompt,
    then one decode step per generated token but the last."""
    n = len(prompt)
    bucket = 8
    while bucket < n:
        bucket *= 2
    toks = torch.zeros((1, bucket), dtype=torch.long, device=DEV)
    toks[0, :n] = torch.as_tensor(prompt, device=DEV)
    cache = model.init_cache(1, max_len, kv_quant=True)
    last, cache = model.prefill(params, toks, cache, ctx,
                                true_len=torch.tensor([n], device=DEV))
    out = [model.logits(params, last)[0, -1].float()]
    for t, tok in enumerate(generated[:-1]):
        logits, cache = model.decode_step(
            params, torch.tensor([[tok]], device=DEV), cache, n + t, ctx)
        out.append(logits[0, -1].float())
    return torch.stack(out)


def path_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.core.reconstruct import quantize_blocks
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 64)), device=DEV)
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_granularity="per_channel", iters=0,
                         rules=("layers.0.*:w_bits=8", "layers.29.*:w_bits=8"))
    torch.cuda.synchronize()
    log(f"path: smollm-135m ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}) initialised in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    x0, blocks, assemble = model.quant_blocks(params, calib)
    fin, astates, reports = quantize_blocks(blocks, recipe, x0)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    export_counts = ops.launch_counts()
    qparams = assemble(fin)
    bits = sorted({(i, qt.bits) for i, layer in enumerate(fin)
                   for grp in ("attn", "mlp") for qt in layer[grp].values()})
    w8_layers = sorted({i for i, b in bits if b == 8})
    errs = [(r.err_before, r.err_after) for r in reports]
    if w8_layers != [0, 29] or not all(math.isfinite(a) and a > 0 and math.isfinite(b)
                                       for a, b in errs):
        fail(f"export: W8 layers {w8_layers}, errors {errs}")
    log(f"export: {len(reports)} blocks in {export_s:.2f}s, launches "
        f"{export_counts}")
    log("export err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    if export_counts["dequant_matmul_w4"] == 0 or export_counts["qmatmul_int8"] == 0:
        fail(f"export pass did not launch K1 and K3: {export_counts}")

    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    econf = EngineConfig(slots=4, max_len=32, prefill_group=2, kv_quant=True)
    engine = ServeEngine(model, qparams, ctx, econf)
    rng = np.random.default_rng(0)
    max_new = 16
    requests = [(i, rng.integers(0, cfg.vocab, size=int(rng.integers(4, 16))
                                 ).astype(np.int64), max_new) for i in range(8)]
    t0 = time.perf_counter()
    outs, prefill_s, decode_s = serve_all(engine, requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()  # the main path's run ends here
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    n_tok = sum(len(v) for v in outs.values())
    if sorted(outs) != list(range(8)) or any(
            len(v) != max_new or min(v) < 0 or max(v) >= cfg.vocab
            for v in outs.values()):
        fail(f"serve: bad outputs {outs}")
    if serve_counts["dequant_matmul_w4"] == 0 or serve_counts["dequant_matmul_w8"] == 0:
        fail(f"serving did not launch K1 and K2: {serve_counts}")
    st = engine.stats()
    log(f"serve: 8 requests x {max_new} tokens on 4 slots in {serve_s:.3f}s -> "
        f"{n_tok / serve_s:.1f} tokens/s ({st['decode_steps']} decode steps, "
        f"{1e3 * decode_s / st['decode_steps']:.2f} ms each; prefill "
        f"calls {st['prefill_calls']}, {prefill_s:.3f}s), launches "
        f"{serve_counts}")
    log(f"serve: hbm_per_slot_bytes {st['hbm_per_slot_bytes']}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")

    # request 0 again along its own greedy path, kernels vs plain versions
    prompt, generated = requests[0][1], outs[0]
    lk = forced_logits(torch, model, qparams, ctx, prompt, generated, 32)
    ctx_t = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                     backend="torch")
    lt = forced_logits(torch, model, qparams, ctx_t, prompt, generated, 32)
    torch.cuda.synchronize()
    # bf16 end to end: both paths round every matmul output and residual
    # add of 30 layers to bfloat16 (2^-9 each) in different places; a CPU
    # rehearsal of float64- vs float32-accumulated matmuls at full width
    # drifted 1.8% (relative L2). A wrong kernel is off by O(1).
    rel = ((lk - lt).norm() / lt.norm()).item()
    dev = (lk - lt).abs().max().item()
    # a greedy token may differ only where the plain path's top two logits
    # lie within twice the largest deviation of each other
    near = lt.gather(1, torch.as_tensor(generated, device=DEV)[:, None])[:, 0]
    ties_ok = bool((near >= lt.max(dim=1).values - 2 * dev).all())
    agree = int((lt.argmax(dim=1).cpu() == torch.as_tensor(generated)).sum())
    log(f"torch backend re-run of request 0: logits relative L2 diff "
        f"{rel:.4e} (tolerance 5e-2), max |diff| {dev:.4e}; greedy tokens "
        f"{agree}/{len(generated)} identical, the others near-ties")
    if not math.isfinite(rel) or rel > 5e-2 or not ties_ok:
        fail("kernel and plain-version serving disagree beyond bf16 tolerance")
    return counts, {"export_s": export_s, "serve_s": serve_s,
                    "tokens_per_s": n_tok / serve_s,
                    "hbm_per_slot_bytes": st["hbm_per_slot_bytes"],
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "err": errs, "export_launches": export_counts,
                    "serve_launches": serve_counts,
                    "decode_steps": st["decode_steps"],
                    "decode_s": decode_s, "prefill_s": prefill_s}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device()  # pins TF32 off for every float32 product below
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f", torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {built} in {time.perf_counter() - t0:.1f}s")
    for src in build.SOURCES:
        report = build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    rows = kernels_phase(torch)
    counts, path = path_phase(torch, np)

    summary = []
    for name in ("dequant_matmul_w4", "dequant_matmul_w8", "qmatmul_int8"):
        M, K, N, x = TIMED[name]
        timed = next(r for r in rows if r["kernel"] == name and "ms" in r
                     and (r["M"], r["K"], r["N"], r["x"]) == (M, K, N, x))
        src, replaces = SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": {"M": M, "K": K, "N": N, "x": x},
        })
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": summary, "rows": rows, "path": path},
        indent=1))
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
