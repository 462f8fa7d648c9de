#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one card with about 50 GB of free device memory (the llama4-scout
path). Phases, each fatal on failure (the exit code is non-zero and the
last line is not printed):

1. Device   — require CUDA; print the card's name and power limit.
2. Build    — compile every CUDA source under src/repro_torch/csrc with
              nvcc (one process per source, in parallel); print the seconds
              and the compiler's register/shared-memory report.
3. Kernels  — hold every kernel against its plain PyTorch version on the
              card, and time kernel, plain version, library yardstick and
              bound with CUDA events:
              K1 (dequant_matmul_w4) and K2 (dequant_matmul_w8) at the
              smollm-135m shapes (every site's (K, N), M in {4, 8, 9, 16,
              32, 64, 512}: both sides of the decode/mma threshold) and the
              llama4-scout 2-D shapes ((5120, 5120), (5120, 1024), (5120,
              8192), (8192, 5120); M in {4, 16, 512}), plus ragged M, N and
              K and misaligned x and codes in both regimes, x in bfloat16
              and float32; each row names the regime the call took. K3
              (qmatmul_int8) at the smollm shapes (M in {4, 64, 512}), the
              llama4 2-D shapes at M = 512 ((5120, 1024) splits K),
              ragged (M = 7 and 130, K = 577, N = 200; M = 130, K = 4097,
              N = 200 in 2 splits), a_q and b_q off 16-byte alignment, and
              the envelope's edge (M = 64, K = 32768, N = 256, every code
              -128: acc = 2^29 through every split's partial sums); its
              int32 accumulator must equal the float64 product exactly,
              and each row names its K splits. Timed K3
              rows hold the whole wrapper (ms), the kernel's launch alone
              (kernel_ms) and the two torch.sum reductions that colsum and
              rowsum would take outside the kernel (sums_ms).
              K5 (dequant_matmul_batched) at the expert shapes, E = 16,
              M in {4, 40}, (K, N) in {(5120, 8192), (8192, 5120)}, packed
              and unpacked codes, x in bfloat16 and float32, plus a ragged
              E = 3, M = 7, N = 200, K = 578 / 577; then x as a decode step
              routes it (4 tokens to 4 distinct experts, to 2 and to 1, the
              other experts' rows zero), an expert zero over part of K
              only, all-zero x, and x and codes off 16-byte alignment in
              both regimes; each row names its regime, and every expert
              whose rows are all zero must come out +0. Routed rows are
              timed against the bound over the active experts' bytes and
              against torch.bmm over the full stack and over the active
              experts only.
              K4 (flexround_quant), bit-exact, at the 2-D site shapes of
              both models and a ragged (7, 200), w in float32 and bfloat16,
              per tensor and per channel, with states from flexround.init
              (mse observer) and s2 = exp(0.05 N(0, 1)).
4. Path     — smollm-135m at full width in bfloat16, weights from
              torch.Generator seed 0: export-only FlexRound PTQ (W4 body, W8
              layers 0 and 29, A8, per-channel) on 8 x 64 calibration tokens,
              then the serving engine (4 slots, max_len 32, buckets
              8/16/32, prefill group 2, int8 KV cache), which captures one
              CUDA graph per bucket and one for decode, answers 8 requests
              of 16 new tokens. The launch counters are zeroed just before
              and read just after (the graphs' replays counted by their
              capture-time tallies, warm-up and capture left out); K1, K2
              and K3 must have launched, K1 and K2 each in both regimes
              (decode from the decode steps, mma from prefill or the
              export). compile_count must be 4 after the build and after
              serving. Then the same requests through the eager engine
              (graphs=False), in a counter window of its own: identical
              greedy tokens and identical launches per kernel and regime.
              Both report decode ms per step, prefill us per bucket, the
              capture seconds and the device memory the build took; 20
              decode steps of each are traced with obs.profiler (device-
              busy share, top 5 device ops). One request is re-run with
              the plain versions (backend "torch") and must agree within
              bfloat16 tolerance.
   Recon graphs — the captured Adam step against the same body run call
              by call: blocks 0 (W8) and 1 (W4, fed block 0's deployed
              output) with the trained phase's weights, calibration set
              and recipe, reconstructed through quantize_blocks with
              graphs=False and then graphed from the same seed; curves,
              errors, activation states and exported codes must be equal
              bit for bit, with two engines built and two step captures
              on the graphed side. Then 20 replayed steps of block 1 are
              traced with obs.profiler (device-busy share of the
              recon.chunk window, device ops per step, top 5) and its
              graph's device time per step is taken with CUDA events.
   Trained  — the same model and weights through the PTQ launcher, in
              process: ``repro_torch.launch.quantize.main`` with the path's
              recipe (W4 body, W8 layers 0 and 29, A8, per-channel), setting
              qdrop, lr 3e-3, 64 x 64 calibration tokens from the launcher's
              SyntheticTokens, minibatches of min(16, calib) = 16 (the
              launcher's), TRAIN_ITERS = 100 iterations (not the default
              200, to keep the phase near a minute), per-block checkpoints
              (--resume-dir), the export (--out) and the scheduler's serve
              run (--serve: 8 requests x 16 new tokens, 4 slots, int8 KV,
              CUDA graphs). Counters zeroed just before the call, read where
              the export hands over to serving (the launcher's
              serve_engine_run is wrapped) and just after: the
              reconstruction's deploy forwards must launch K1 and K3,
              serving K1 and K2, exactly what phase 4's graphed serving
              launched (warm-up and capture are not counted), with
              compile_count 4. The reconstruction replays captured
              steps: engine_stats() must show 2 engines built and 2 step
              captures (the W8 layers 0/29, the W4 body), every block's
              report engine "graph". Reports the
              launcher's seconds, seconds and steps/s per block and in
              total, the engine's counters and the captures' seconds,
              err_before/err_after per block; fails on a non-finite
              error, or unless the errors' sum after training is below both
              its own sum before and the export-only run's sum. Request 0
              is re-run with the plain versions (5e-2 relative L2).
   Auto-bits — the trained phase's launcher command plus ``--auto-bits
              4.5`` (avg_bits budget, combined objective, AUTO_ITERS = 100
              iterations), ``--resume-dir`` and ``--serve``: the sensitivity
              probe (every site at 2, 3, 4 and 8 bits; its body captured
              once per apply_key and bit width and replayed per site),
              the solver, the emitted rules over the recipe's, the
              reconstruction (one captured step per distinct per-site bit
              vector), the export and the scheduler's serve run, counters
              zeroed before and read after. The recorded allocation must
              meet its budget (avg_bits <= 4.5) and use at least two bit
              widths; every export QTensor carries its site's allocated
              bits, every 2- or 3-bit one nibble-packed; K1 is held against
              its plain version through the deploy dispatch on one 2-bit
              and one 3-bit QTensor of the export at M = 4 and 512; request
              0 is re-run with the plain versions. The same command again
              must reuse the recorded allocation, probe nothing, resume
              every block and export the same tensors bit for bit; the
              command at ``--auto-bits 4.0`` against the same checkpoints
              must raise the budget-mismatch ValueError. Reports the
              probe's steps, seconds, probe bodies and capture seconds,
              its split between the RTN state inits (the mse observer) and
              the replays, the engines and step captures, the peak device
              memory, the error sums beside the trained phase's, and
              serve tokens/s and decode ms per step.
   Preempt  — the same recipe at PREEMPT_ITERS = 10 iterations: a launcher
              run without a break (export A); the same command in a
              subprocess with --resume-dir D, sent SIGKILL once D's
              checkpoint records next_block >= PREEMPT_AT = 10; the same
              command in process, resuming from D (export B). All three
              replay captured steps. Every tensor
              of B must equal A's bit for bit, and every block's err_before
              and err_after; reports the seconds of the three runs.
5. MoE path — llama4-scout-17b-a16e at full width (d_model 5120, 16
              experts, top-1, shared expert, vocab 202048) and 4 of its 48
              layers, bfloat16, weights from torch.Generator seed 0:
              K4 through ops.flexround_fake_quant on every 2-D site of
              layer 0 (its own counter window; bit-exact against the plain
              version); then export-only PTQ (W4 body, W8 layers 0 and 3,
              A8, per-channel, mse observer) on 8 x 64 calibration tokens
              and the same serving runs as phase 4 (graphed, eager,
              profiled). K5 must launch packed
              and unpacked in the export and in serving, in the mma regime
              in the export and the decode regime in serving, and K1, K2
              and K3 must launch, K1 and K2 in both regimes. One MoE FFN
              of a W8 and of a W4 layer is fed the
              same hidden input with backend "auto" and "torch": identical
              routing, outputs within bfloat16 tolerance. Request 0 is
              re-run with the plain versions; the relative L2 of its logits
              and the number of routing decisions that differ are reported.

The line before the last is the JSON kernel summary (K1-K5); the last line
is ``{"ok": true, "device": {...}}``. A per-shape table goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import shutil
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
# llama4-scout's 2-D sites (attention, shared expert) and expert stacks
LLAMA4_2D = ((5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))
LLAMA4_EXPERTS = ((5120, 8192), (8192, 5120))
LLAMA4_E = 16
LLAMA4_LAYERS = 4  # of 48: the bf16 weights of 4 layers take 21.8 GB
# the launcher's default is 200 (repro/launch/quantize.py); the phase has
# run 100 since the steps were eager (200 took 126 s on an H100, PERF.md),
# and keeps 100 so that its numbers compare with those runs
TRAIN_ITERS = 100
# the preemption phase: iterations per block, and the block after whose
# checkpoint the launcher subprocess is killed
PREEMPT_ITERS = 10
PREEMPT_AT = 10
# the auto-bits phase: the launcher's --auto-bits budget (numel-weighted
# average bits), iterations per block, and the budget of its refused resume
AUTO_BITS = "4.5"
AUTO_ITERS = TRAIN_ITERS
AUTO_BITS_OTHER = "4.0"
# checkpoints and exports of the launcher phases (under build/, gitignored)
RUNS_DIR = ROOT / "build" / "chip_smoke_runs"
# the shape each kernel's summary line reports: (M, K, N, x) of a matmul;
# for K4 (M, N, w) of the weight
TIMED = {
    "dequant_matmul_w4": (4, 576, 1536, "bfloat16"),   # decode, w_gate/w_up
    "dequant_matmul_w8": (4, 576, 1536, "bfloat16"),   # decode, layers 0, 29
    "qmatmul_int8": (512, 576, 1536, "int8"),          # export pass, W8A8
    "flexround_quant": (8192, 5120, "bfloat16"),       # llama4 w_down
    "dequant_matmul_batched": (4, 5120, 8192, "bfloat16"),  # decode, W4
}
KERNEL_NAMES = tuple(TIMED)
SOURCES = {
    "dequant_matmul_w4": ("src/repro_torch/csrc/dequant_matmul_2d.cu",
                          "src/repro/kernels/dequant_matmul_w4.py:135"),
    "dequant_matmul_w8": ("src/repro_torch/csrc/dequant_matmul_2d.cu",
                          "src/repro/kernels/dequant_matmul_w4.py:144"),
    "qmatmul_int8": ("src/repro_torch/csrc/qmatmul_int8.cu",
                     "src/repro/kernels/qmatmul_int8.py:58"),
    "flexround_quant": ("src/repro_torch/csrc/flexround_quant.cu",
                        "src/repro/kernels/flexround_quant.py:32"),
    "dequant_matmul_batched": ("src/repro_torch/csrc/dequant_matmul_2d.cu",
                               "src/repro/kernels/dequant_matmul_w4.py:157"),
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


def _copies(wbytes: int, extra_bytes: int = 0) -> int:
    """How many copies of a call's weight to rotate through: enough that
    the weights together exceed twice the L2 (so each call reads its weight
    from device memory, as a decode step does), at least 2, and otherwise
    at most what keeps the weights and their yardstick copies
    (``extra_bytes`` each, e.g. the dequantized bf16 weight) within about
    4 GB; never more than 256."""
    fit = (4 * 2**30) // (wbytes + extra_bytes)
    return max(2, min(256, math.ceil(2 * L2_BYTES / wbytes), fit))


def roofline(n_ops: float, in_type: str, byte_count: int):
    """Least time (ms) for the work: bytes over the memory rate vs ops over
    the peak rate for the input type; returns (ms, "bytes"|"operations")."""
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[in_type]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(M: int, K: int, N: int, in_type: str, byte_count: int):
    """Roofline of an (M, K) x (K, N) product: 2*M*K*N operations."""
    return roofline(2.0 * M * K * N, in_type, byte_count)


# ----------------------------------------------------------------- kernels
def _misaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary, so the kernels must take their scalar-load path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_dequant(torch, kern, ref, name, M, K, N, dtype, gen, timed,
                  misalign=False):
    """K1/K2 against the plain version; the row names the regime the call
    took (read from the wrapper's per-form counter) and must match
    ``plan``. ``misalign`` moves x and codes off their 16-byte alignment."""
    packed = name == "dequant_matmul_w4"
    bits = 4 if packed else 8
    x = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
    rows = K // 2 if packed else K
    codes = torch.randint(0, 256 if packed else 2**bits, (rows, N),
                          generator=gen, device=DEV, dtype=torch.uint8)
    if misalign:
        x, codes = _misaligned(torch, x), _misaligned(torch, codes)
    scale = (torch.exp(torch.randn((1, N), generator=gen, device=DEV) * 0.2)
             * 0.2 / (2**bits - 1))
    zero = torch.round(torch.rand((1, N), generator=gen, device=DEV)
                       * (2**bits - 1))
    fn = getattr(kern, name)
    plain = getattr(ref, f"{name}_ref")
    p = kern.plan(M, K, N, dtype, packed, x.data_ptr(), codes.data_ptr())
    forms = dict(fn.forms)
    got = fn(x, codes, scale, zero)
    took = [f for f in forms if fn.forms[f] != forms[f]]
    want = plain(x, codes, scale, zero)
    torch.cuda.synchronize()
    if took != [p.regime] or (misalign and (p.vec_codes or p.vec_x)):
        fail(f"{name} {M}x{K}x{N} {dtype}: launched {took}, planned {p}")
    if got.dtype != dtype or got.shape != (M, N) or not torch.isfinite(got).all():
        fail(f"{name} {M}x{K}x{N} {dtype}: bad output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    w = None if dtype == torch.bfloat16 else scale * (
        (ref.unpack_f32(codes) if packed else codes.float()) - zero)
    tol = _matmul_tol(torch, x, w, want, K)
    del w
    if not bool((err <= tol).all()):
        fail(f"{name} {M}x{K}x{N} {dtype}: max |err| {err.max().item():.3e} "
             f"beyond the stated tolerance")
    row = {"kernel": name, "M": M, "K": K, "N": N,
           "x": str(dtype).replace("torch.", ""), "regime": p.regime,
           "tile": p.kernel, "splits": p.splits, "misaligned": misalign,
           "max_abs_err": err.max().item()}
    if timed:
        wbytes = codes.numel() + 8 * N
        ybytes = K * N * x.element_size()  # the dequantized yardstick
        sets = [(x, codes.clone(), scale, zero)
                for _ in range(_copies(wbytes, ybytes))]
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


def check_int8(torch, kern, ref, M, K, N, gen, timed, codes="random",
               misalign=False):
    """K3 against its plain version. First with unit scales and zero
    offsets, where out is float32(acc): the int32 accumulator must equal
    the float64 product exactly. ``codes="min"`` sets every code of both
    operands to -128 (acc = 2^14 K, the envelope's edge at K = 32768);
    ``misalign`` moves a_q and b_q off their 16-byte alignment. The row
    names the K splits of the call; timed rows hold the whole wrapper
    (``ms``), the kernel's launch alone (``kernel_ms``) and the two
    torch.sum reductions the wrapper no longer runs (``sums_ms``)."""
    if codes == "min":
        a_q = torch.full((M, K), -128, device=DEV, dtype=torch.int8)
        b_q = torch.full((K, N), -128, device=DEV, dtype=torch.int8)
    else:
        a_q = torch.randint(-128, 128, (M, K), generator=gen, device=DEV,
                            dtype=torch.int8)
        b_q = torch.randint(-128, 128, (K, N), generator=gen, device=DEV,
                            dtype=torch.int8)
    if misalign:
        a_q, b_q = _misaligned(torch, a_q), _misaligned(torch, b_q)
    p = kern.plan(M, K, N, a_ptr=a_q.data_ptr(), b_ptr=b_q.data_ptr())
    tag = (f"qmatmul_int8 {M}x{K}x{N} codes={codes}"
           f"{' misaligned' if misalign else ''} splits={p.splits}")
    if misalign and (p.vec_a or p.vec_b):
        fail(f"{tag}: misaligned operands planned for 16-byte copies: {p}")
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
        fail(f"{tag}: int32 accumulator is not exact "
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
        fail(f"{tag}: max |err| {err.max().item():.3e} beyond the epilogue "
             "rounding bound")
    row = {"kernel": "qmatmul_int8", "M": M, "K": K, "N": N, "x": "int8",
           "codes": codes, "misaligned": misalign, "splits": p.splits,
           "max_abs_err": err.max().item()}
    if timed:
        wbytes = b_q.numel() + 8 * N
        sets = [(a_q, b_q.clone(), a_scale, a_zero, b_scale, b_zero)
                for _ in range(_copies(wbytes))]
        row["ms"] = cuda_ms(torch, kern.qmatmul_int8, sets)
        row["eager_ms"] = eager_ms(torch, kern.qmatmul_int8, sets)
        a_s, a_z = a_scale.reshape(1), a_zero.reshape(1)
        bufs = [(torch.empty((M, N), device=DEV),
                 torch.empty((p.workspace_bytes // 4,), dtype=torch.int32,
                             device=DEV) if p.splits > 1 else None)
                for _ in sets]

        def launch_only(a, b, out, ws):
            kern.launch(p, a, b, a_s, a_z, b_scale, b_zero, out, ws)

        row["kernel_ms"] = cuda_ms(torch, launch_only, [
            (s[0], s[1]) + o for s, o in zip(sets, bufs)])

        def sums(a, b):  # colsum and rowsum as two reductions
            torch.sum(b, dim=0, keepdim=True, dtype=torch.int32)
            torch.sum(a, dim=1, keepdim=True, dtype=torch.int32)

        row["sums_ms"] = cuda_ms(torch, sums, [(s[0], s[1]) for s in sets])
        row["plain_ms"] = cuda_ms(torch, ref.qmatmul_int8_ref, sets)
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            row["library_ms"] = cuda_ms(torch, torch._int_mm,
                                        [(s[0], s[1]) for s in sets])
        else:
            row["library_ms"] = None  # torch._int_mm needs M > 16
        nbytes = a_q.numel() + wbytes + 8 + 4 * M * N
        row["bound_ms"], row["bound_by"] = bound(M, K, N, "int8", nbytes)
        del sets, bufs
    return row


def _matmul_tol(torch, x, w, want, K):
    """The stated tolerance of a dequant matmul: at most one bf16 step in
    bfloat16 (both sides round one float32 sum to bfloat16); in float32 a
    few sqrt(K) roundings of the sum of |terms| (the kernel accumulates
    sequentially per thread, cuBLAS in blocks)."""
    if x.dtype == torch.bfloat16:
        return 2e-2 + 2e-2 * want.float().abs()
    return 1e-5 + 8 * math.sqrt(K) * 2.0**-24 * torch.matmul(x.abs(), w.abs())


# K5's rows of x: "dense" (every row non-zero); as a decode step's dispatch
# builds them from 4 tokens routed top-1 to 4, 2 or 1 experts ("routed4",
# "routed2", "routed1"), the other experts' rows zero; "partial" (expert 1
# zero over the first half of K only, expert 2 all zero, the rest dense);
# "zero" (every row zero, half of the experts -0)
K5_ROUTED = {"routed4": (1, 6, 9, 14), "routed2": (3, 3, 12, 12),
             "routed1": (5, 5, 5, 5)}


def _k5_x(torch, E, M, K, dtype, pattern, gen):
    if pattern in K5_ROUTED:
        # the dispatch einsum of models/moe.py: token t to slot c of expert e
        experts = K5_ROUTED[pattern]
        tokens = torch.randn((len(experts), K), generator=gen,
                             device=DEV).to(dtype)
        dispatch = torch.zeros((len(experts), E, M), device=DEV, dtype=dtype)
        filled = {}
        for t, e in enumerate(experts):
            dispatch[t, e, filled.get(e, 0)] = 1
            filled[e] = filled.get(e, 0) + 1
        return torch.einsum("tec,tk->eck", dispatch, tokens).contiguous()
    x = torch.randn((E, M, K), generator=gen, device=DEV).to(dtype)
    if pattern == "partial":
        x[1, :, :K // 2] = 0
        x[2] = 0
    elif pattern == "zero":
        x.zero_()
        x[::2] = -0.0
    return x


def check_batched(torch, kern, ref, E, M, K, N, packed, dtype, gen, timed,
                  pattern="dense", misalign=False):
    """K5 against its plain version: x (E, M, K) as ``pattern`` lays out its
    rows, codes (E, K/2 or K, N); the row names the regime the call took,
    which must match ``plan``, and experts whose rows of x are all zero must
    give exactly +0. ``misalign`` moves x and codes off 16 bytes."""
    bits = 4 if packed else 8
    x = _k5_x(torch, E, M, K, dtype, pattern, gen)
    codes = torch.randint(0, 256 if packed else 2**bits,
                          (E, K // 2 if packed else K, N), generator=gen,
                          device=DEV, dtype=torch.uint8)
    if misalign:
        x, codes = _misaligned(torch, x), _misaligned(torch, codes)
    scale = (torch.exp(torch.randn((E, 1, N), generator=gen, device=DEV) * 0.2)
             * 0.2 / (2**bits - 1))
    zero = torch.round(torch.rand((E, 1, N), generator=gen, device=DEV)
                       * (2**bits - 1))
    fn = kern.dequant_matmul_batched
    p = kern.plan(M, K, N, dtype, packed, x.data_ptr(), codes.data_ptr(), E=E)
    forms = dict(fn.forms)
    got = fn(x, codes, scale, zero, packed)
    took = sorted(f for f in forms if fn.forms[f] != forms[f])
    want = ref.dequant_matmul_batched_ref(x, codes, scale, zero, packed)
    torch.cuda.synchronize()
    tag = (f"dequant_matmul_batched E={E} {M}x{K}x{N} packed={packed} {dtype} "
           f"x={pattern}{' misaligned' if misalign else ''}")
    if took != sorted([p.regime, "packed" if packed else "unpacked"]) or (
            misalign and (p.vec_codes or p.vec_x)):
        fail(f"{tag}: launched {took}, planned {p}")
    if got.dtype != dtype or got.shape != (E, M, N) or not torch.isfinite(got).all():
        fail(f"{tag}: bad output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    w = None if dtype == torch.bfloat16 else scale * (
        (ref.unpack_f32(codes, axis=1) if packed else codes.float()) - zero)
    tol = _matmul_tol(torch, x, w, want, K)
    del w
    if not bool((err <= tol).all()):
        fail(f"{tag}: max |err| {err.max().item():.3e} beyond the stated "
             "tolerance")
    active = (x != 0).flatten(1).any(1)  # experts holding a non-zero row
    empty = got[~active].float()
    if bool((empty != 0).any()) or bool(torch.signbit(empty).any()):
        fail(f"{tag}: an expert with all-zero x did not give +0")
    n_active = int(active.sum())
    row = {"kernel": "dequant_matmul_batched", "E": E, "M": M, "K": K,
           "N": N, "packed": packed, "x": str(dtype).replace("torch.", ""),
           "x_rows": pattern, "active_experts": n_active, "regime": p.regime,
           "tile": p.kernel, "splits": p.splits, "misaligned": misalign,
           "max_abs_err": err.max().item()}
    if timed:
        wbytes = codes.numel() + 8 * E * N
        ybytes = E * K * N * x.element_size()  # the dequantized yardstick
        sets = [(x, codes.clone(), scale, zero, packed)
                for _ in range(_copies(wbytes, ybytes))]
        row["ms"] = cuda_ms(torch, fn, sets)
        row["eager_ms"] = eager_ms(torch, fn, sets)
        row["plain_ms"] = cuda_ms(torch, ref.dequant_matmul_batched_ref, sets)
        # yardstick: one batched cuBLAS product (torch.bmm) on the stack
        # dequantized beforehand; for routed x also on the active experts
        # alone, so that the skip is not flattered by the full stack
        wdeq = [(x, (scale * ((ref.unpack_f32(c, axis=1) if packed
                                else c.float()) - zero)).to(dtype))
                for _, c, _, _, _ in sets]
        row["library_ms"] = cuda_ms(torch, torch.bmm, wdeq)
        xbytes = x.numel() * x.element_size()
        obytes = E * M * N * x.element_size()
        if n_active < E:
            idx = active.nonzero()[:, 0]
            row["library_active_ms"] = cuda_ms(
                torch, torch.bmm, [(xx[idx].contiguous(), ww[idx].contiguous())
                                   for xx, ww in wdeq])
        # each input read once, the output written once; codes, scale and
        # zero of the experts this run's x needs
        nbytes = xbytes + wbytes * n_active // E + obytes
        row["bound_ms"], row["bound_by"] = bound(n_active * M, K, N, row["x"],
                                                 nbytes)
        del wdeq, sets
    return row


def check_flexround(torch, kern, ref, M, N, dtype, per_channel, gen, timed):
    """K4 against its plain version, bit for bit, through the entry point
    ``ops.flexround_fake_quant`` (kernel) and its ``torch`` backend, on a
    state from ``flexround.init`` (mse observer) with s2 = exp(0.05 N(0,1))."""
    from repro_torch.core import flexround
    from repro_torch.core.quant_config import QuantConfig
    from repro_torch.kernels import ops
    qcfg = QuantConfig(bits=4, observer="mse", granularity=(
        "per_channel" if per_channel else "per_tensor"))
    w = (torch.randn((M, N), generator=gen, device=DEV) * M**-0.5).to(dtype)
    st = flexround.init(w, qcfg)
    st["s2"] = torch.exp(0.05 * torch.randn((M, N), generator=gen, device=DEV))
    before = kern.flexround_quant.launches
    got = ops.flexround_fake_quant(w, st, qcfg)
    launched = kern.flexround_quant.launches - before
    want = ops.flexround_fake_quant(w, st, qcfg, backend="torch")
    torch.cuda.synchronize()
    tag = (f"flexround_quant {M}x{N} {dtype} "
           f"{'per_channel' if per_channel else 'per_tensor'}")
    if launched != 1 or got.dtype != dtype or got.shape != (M, N):
        fail(f"{tag}: kernel launched {launched} times, output {got.dtype} "
             f"{tuple(got.shape)}")
    if not torch.equal(got, want):
        fail(f"{tag}: not bit-exact, {int((got != want).sum())} elements "
             f"differ, max |err| {(got.float() - want.float()).abs().max().item():.3e}")
    row = {"kernel": "flexround_quant", "M": M, "N": N,
           "x": str(dtype).replace("torch.", ""),
           "granularity": qcfg.granularity, "max_abs_err": 0.0}
    if timed:
        n = w.shape[1]
        rows = [ops._row(st[k], n, w.device) for k in ("s1", "s3", "zero")]
        wbytes = w.numel() * w.element_size() + st["s2"].numel() * 4

        def kernel(w_, s2_):
            return kern.flexround_quant(w_, rows[0], s2_, rows[1], rows[2],
                                        qmin=qcfg.qmin, qmax=qcfg.qmax)

        def plain(w_, s2_):
            return ref.flexround_quant_ref(w_, rows[0], s2_, rows[1], rows[2],
                                           qcfg.qmin, qcfg.qmax)

        sets = [(w.clone(), st["s2"].clone()) for _ in range(_copies(wbytes))]
        row["ms"] = cuda_ms(torch, kernel, sets)
        row["eager_ms"] = eager_ms(torch, kernel, sets)
        row["plain_ms"] = cuda_ms(torch, plain, sets)
        row["library_ms"] = None  # no single PyTorch call computes Eq. 2
        # each of w, s2 read once, out written once, three (1, N) rows; ~6
        # float32 operations per element
        nbytes = wbytes + w.numel() * w.element_size() + 12 * N
        row["bound_ms"], row["bound_by"] = roofline(6.0 * M * N, "float32",
                                                    nbytes)
        del sets
    return row


def _log_rows(rows):
    for r in rows:
        if "ms" not in r:
            continue
        if r["kernel"] == "flexround_quant":
            shape = f"M={r['M']:5d} N={r['N']:5d} w={r['x']:8s}"
        else:
            shape = (f"{'E=%d ' % r['E'] if 'E' in r else ''}M={r['M']:4d} "
                     f"K={r['K']:5d} N={r['N']:5d} x={r['x']:8s}"
                     + (f" packed={r['packed']} rows={r['x_rows']}"
                        f"({r['active_experts']})" if "packed" in r else "")
                     + (f" {r['regime']:6s} tile={r['tile']} "
                        f"splits={r['splits']:2d}" if "regime" in r else ""))
        if r["kernel"] == "qmatmul_int8":
            shape += (f" splits={r['splits']:2d} kernel_ms={r['kernel_ms']:.5f}"
                      f" sums_ms={r['sums_ms']:.5f}")
        active = (f" library_active_ms={r['library_active_ms']}"
                  if "library_active_ms" in r else "")
        log(f"  {r['kernel']:22s} {shape} ms={r['ms']:.5f} "
            f"eager_ms={r['eager_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']}{active} bound_ms="
            f"{r['bound_ms']:.5f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3e}")


def kernels_phase(torch):
    from repro_torch.kernels import dequant_matmul_w4 as k12
    from repro_torch.kernels import flexround_quant as k4
    from repro_torch.kernels import qmatmul_int8 as k3
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    shapes = sorted(set(SMOLLM_SITES.values()))
    k12_names = ("dequant_matmul_w4", "dequant_matmul_w8")
    # K1/K2 regimes: decode up to DECODE_MAX_M rows of bf16 x (and float32
    # x at any M), tensor cores above; M on both sides of the threshold
    edge = k12.DECODE_MAX_M
    for M in (4, edge, edge + 1, 16, 32, 64, 512):
        for K, N in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                timed = dtype == torch.bfloat16 and M in (4, 16, 64, 512)
                for name in k12_names:
                    rows.append(check_dequant(torch, k12, ref, name, M, K, N,
                                              dtype, gen, timed))
            if M in (4, 64, 512):
                rows.append(check_int8(torch, k3, ref, M, K, N, gen,
                                       timed=True))
    # ragged M, N and K tiles and x and codes off their 16-byte alignment,
    # on every kernel: bf16 M=7 decode, M=40 and M=130 (two row tiles)
    # wgmma; float32 x
    for M in (7, 40, 130):
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w4", M,
                                      578, 200, dtype, gen, False))
            rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w8", M,
                                      577, 200, dtype, gen, False))
            for name in k12_names:
                rows.append(check_dequant(torch, k12, ref, name, M, 576, 1536,
                                          dtype, gen, False, misalign=True))
    # K3: ragged M, N and K (one and two row tiles), a_q and b_q off 16
    # bytes, and the envelope's edge: K = 32768 with every code -128, so
    # acc = 2^29 through every split's int32 partial sums
    for M, K in ((7, 577), (130, 577), (130, 4097)):  # the last splits K
        rows.append(check_int8(torch, k3, ref, M, K, 200, gen, timed=False))
    rows.append(check_int8(torch, k3, ref, 512, 576, 1536, gen, timed=False,
                           misalign=True))
    rows.append(check_int8(torch, k3, ref, 64, k3.K_MAX, 256, gen,
                           timed=False, codes="min"))
    # llama4-scout's 2-D sites: decode, prefill and export
    for M in (4, 16, 512):
        for K, N in LLAMA4_2D:
            for dtype in (torch.bfloat16, torch.float32):
                for name in ("dequant_matmul_w4", "dequant_matmul_w8"):
                    rows.append(check_dequant(torch, k12, ref, name, M, K, N,
                                              dtype, gen,
                                              dtype == torch.bfloat16))
    for K, N in LLAMA4_2D:
        rows.append(check_int8(torch, k3, ref, 512, K, N, gen, timed=True))
    # K5 at the expert stacks: decode / prefill (C = 4) and export (C = 40)
    for M in (4, 40):
        for K, N in LLAMA4_EXPERTS:
            for packed in (True, False):
                for dtype in (torch.bfloat16, torch.float32):
                    rows.append(check_batched(torch, k12, ref, LLAMA4_E, M, K,
                                              N, packed, dtype, gen,
                                              dtype == torch.bfloat16))
            torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):  # ragged E, M, N and K
        rows.append(check_batched(torch, k12, ref, 3, 7, 578, 200, True,
                                  dtype, gen, False))
        rows.append(check_batched(torch, k12, ref, 3, 7, 577, 200, False,
                                  dtype, gen, False))
    # K5's skip: x as a decode step routes it, timed at both expert shapes;
    # an expert zero over part of K only and all-zero x in every regime
    # (the ragged decode call splits K, so blocks skip some splits of a
    # tile and compute others); x and codes off 16 bytes in both regimes
    for K, N in LLAMA4_EXPERTS:
        for packed in (True, False):
            for pattern in ("routed4", "routed2", "routed1"):
                rows.append(check_batched(
                    torch, k12, ref, LLAMA4_E, 4, K, N, packed,
                    torch.bfloat16, gen, pattern == "routed4" or (
                        packed and (K, N) == LLAMA4_EXPERTS[0]), pattern))
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        for M in (4, 40):
            for pattern in ("partial", "zero"):
                rows.append(check_batched(torch, k12, ref, LLAMA4_E, M, 5120,
                                          8192, True, dtype, gen, False,
                                          pattern))
        for M in (7, 40):
            rows.append(check_batched(torch, k12, ref, 3, M, 578, 200, True,
                                      dtype, gen, False, "partial"))
            rows.append(check_batched(torch, k12, ref, 3, M, 577, 200, False,
                                      dtype, gen, False, "partial"))
            for packed in (True, False):
                rows.append(check_batched(torch, k12, ref, 3, M, 576, 1536,
                                          packed, dtype, gen, False,
                                          "partial", misalign=True))
        torch.cuda.empty_cache()
    # K4 at the 2-D site shapes of both models, and ragged
    k4_shapes = sorted(set(LLAMA4_2D) | {(576, 1536), (1536, 576)}) + [(7, 200)]
    for M, N in k4_shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for per_channel in (False, True):
                rows.append(check_flexround(
                    torch, k4, ref, M, N, dtype, per_channel, gen,
                    timed=(dtype == torch.bfloat16 and per_channel
                           and (M, N) != (7, 200))))
    _log_rows(rows)
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


def serve_requests(np, vocab):
    """8 requests of 4-15 prompt tokens x 16 new tokens (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 16))
                             ).astype(np.int64), 16) for i in range(8)]


def run_engine(torch, np, model, qparams, ctx, graphs=True):
    """The serving run of both paths: 4 slots, max_len 32, prefill group 2,
    int8 KV; the 8 requests of ``serve_requests``, through CUDA graphs
    (``graphs``) or the eager engine. Returns (requests, {rid: tokens},
    stats, engine); the stats hold the build's seconds, capture seconds and
    device memory (allocated and reserved, measured with empty caches
    around the engine's construction: the graph pool and the slot state)."""
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    vocab = model.cfg.vocab
    econf = EngineConfig(slots=4, max_len=32, prefill_group=2, kv_quant=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine = ServeEngine(model, qparams, ctx, econf, graphs=graphs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    build_mem = {"allocated": torch.cuda.memory_allocated() - alloc0,
                 "reserved": torch.cuda.memory_reserved() - res0}
    compiled = engine.compile_count
    requests = serve_requests(np, vocab)
    max_new = requests[0][2]
    t0 = time.perf_counter()
    outs, prefill_s, decode_s = serve_all(engine, requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if sorted(outs) != list(range(8)) or any(
            len(v) != max_new or min(v) < 0 or max(v) >= vocab
            for v in outs.values()):
        fail(f"serve: bad outputs {outs}")
    st = engine.stats()
    want = len(engine.buckets) + 1 if graphs else 0
    if not compiled == engine.compile_count == want:
        fail(f"serve: compile_count {compiled} after the build, "
             f"{engine.compile_count} after serving, {want} expected")
    n_tok = sum(len(v) for v in outs.values())
    mode = "graphed" if graphs else "eager"
    stats = {"mode": mode, "serve_s": serve_s, "tokens_per_s": n_tok / serve_s,
             "decode_steps": st["decode_steps"], "decode_s": decode_s,
             "decode_ms_per_step": 1e3 * decode_s / st["decode_steps"],
             "prefill_s": prefill_s, "prefill_calls": st["prefill_calls"],
             "prefill_us": st["prefill_us"], "compile_count": compiled,
             "compile_us": st["compile_us"],
             "capture_s": sum(st["compile_us"].values()) / 1e6,
             "build_s": build_s, "build_memory_bytes": build_mem,
             "build_launches": st["build_launches"],
             "hbm_per_slot_bytes": st["hbm_per_slot_bytes"]}
    pf = " ".join(f"b{b}={h['p50']:.0f}us(n={int(h['count'])})"
                  for b, h in sorted(st["prefill_us"].items()))
    log(f"serve [{mode}]: 8 requests x {max_new} tokens on 4 slots in "
        f"{serve_s:.3f}s -> {stats['tokens_per_s']:.1f} tokens/s "
        f"({st['decode_steps']} decode steps, "
        f"{stats['decode_ms_per_step']:.3f} ms each; prefill p50 {pf}, "
        f"{prefill_s:.3f}s)")
    log(f"serve [{mode}]: build {build_s:.3f}s, compile_count {compiled}, "
        f"capture {stats['capture_s']:.3f}s "
        f"({ {k: round(v) for k, v in st['compile_us'].items()} } us), "
        f"device memory allocated {build_mem['allocated']} B, reserved "
        f"{build_mem['reserved']} B (graph pool and slot state)")
    return requests, outs, stats, engine


def compare_eager(torch, np, model, qparams, ctx, outs, serve_counts):
    """The same requests through the eager engine (``graphs=False``), in a
    counter window of its own: the greedy tokens and the launches per
    kernel and regime must equal the graphed run's."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    _, eager_outs, stats, engine = run_engine(torch, np, model, qparams, ctx,
                                              graphs=False)
    after = ops.launch_counts()
    eager_counts = {k: after[k] - before[k] for k in after}
    same = sum(eager_outs[r] == outs[r] for r in outs)
    log(f"graphed vs eager: greedy tokens identical for {same}/{len(outs)} "
        f"requests; launches equal: {eager_counts == serve_counts}")
    if same != len(outs):
        fail(f"graphed and eager engines disagree: {outs} vs {eager_outs}")
    if eager_counts != serve_counts:
        fail(f"graphed launches {serve_counts} differ from eager "
             f"{eager_counts}")
    return stats, engine


def profile_decode(torch, np, engine, tag, steps=20):
    """``steps`` decode steps of 4 active slots traced with obs.profiler
    (after two untraced ones): the device-busy share of the steps' window
    and the device ops with the most time in it (``device_window``; None
    for the share when the trace holds no device activity). Tracing slows
    each step, so a graphed engine
    also has its decode graph replayed ``steps`` times back to back, the
    slots drained, between CUDA events: the device's span of one step
    without the host's replay, sync and bookkeeping, and without the
    profiler."""
    from repro_torch.obs import profiler
    vocab = engine.model.cfg.vocab
    rng = np.random.default_rng(1)
    reqs = [(100 + i, rng.integers(0, vocab, 6).astype(np.int64), steps + 4)
            for i in range(4)]
    for i in range(0, 4, 2):
        engine.admit(reqs[i:i + 2])
    engine.step()
    engine.step()
    d = RUNS_DIR / f"profile_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    with profiler.trace(str(d)):
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        wall_s = time.perf_counter() - t0
    while engine.active:
        engine.step()
    engine.drain_finished()
    graph_ms = None
    graph = engine._graphs.get("decode", (None,))[0]
    if graph is not None:  # every slot inactive: positions stay in range
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            graph.replay()
        end.record()
        end.synchronize()
        graph_ms = start.elapsed_time(end) / steps
    win = device_window(d, "serve.decode_step")
    res = {"steps": win.pop("marks"), "wall_ms_per_step": 1e3 * wall_s / steps,
           "graph_ms_per_step": graph_ms, **win}
    if res["device_busy_share"] is None:
        log(f"profile [{tag}]: {res['steps']} decode steps traced, no device "
            "activity in the trace: device-busy share not measured")
        return res
    log(f"profile [{tag}]: {res['steps']} decode steps, window "
        f"{res['window_ms']:.3f} ms, device busy {res['device_busy_ms']:.3f} "
        f"ms ({100 * res['device_busy_share']:.1f}%), {res['device_ops']} "
        f"device ops, {res['wall_ms_per_step']:.3f} ms per traced step; "
        f"decode graph's device span per step "
        f"{'-' if graph_ms is None else f'{graph_ms:.3f} ms'}; top 5: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.3f} ms" for t in res["top5"]))
    return res


def device_window(trace_dir, mark):
    """Read (and delete) the Chrome trace in ``trace_dir``: the device
    activity inside the window from the first ``mark`` annotation's start
    to the last one's end. ``device_busy_share`` is the union of kernel,
    memcpy and memset intervals over the window's wall time (None when the
    trace holds no device activity); ``top5`` the device ops with the most
    time in it."""
    files = sorted(trace_dir.glob("*.json"))
    events = json.loads(files[-1].read_text())["traceEvents"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == mark]
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            spans.append((a, b))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window_us = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"marks": len(marks), "window_ms": window_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window_us if spans else None,
            "device_ops": len(spans),
            "top5": [{"name": n[:120], "ms": t / 1e3} for n, t in top]}


def serve_phase(torch, np, model, qparams, ctx, export_counts, tag):
    """The main path's serving run (graphed) with the counters running,
    then, after the main path's counters are read, the eager comparison
    and the two profiled decode windows. Returns (counts at the end of the
    main path, requests, outputs, stats)."""
    from repro_torch.kernels import ops
    requests, outs, stats, engine = run_engine(torch, np, model, qparams, ctx)
    counts = ops.launch_counts()  # the main path's run ends here
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    log(f"serve launches {serve_counts}; warm-up and capture (not counted) "
        f"{stats['build_launches']}")
    eager, eager_engine = compare_eager(torch, np, model, qparams, ctx, outs,
                                        serve_counts)
    stats = dict(stats, serve_launches=serve_counts, eager=eager)
    stats["profile"] = {"graphed": profile_decode(torch, np, engine,
                                                  f"{tag}_graphed"),
                        "eager": profile_decode(torch, np, eager_engine,
                                                f"{tag}_eager")}
    return counts, requests, outs, stats


def export(torch, model, params, calib, recipe, w8_layers):
    """FlexRound PTQ (export-only when ``recipe.iters`` is 0); returns
    (finalized layers, astates, seconds, per-block errors, reports)."""
    from repro_torch.core.reconstruct import quantize_blocks
    t0 = time.perf_counter()
    x0, blocks, _ = model.quant_blocks(params, calib)
    fin, astates, reports = quantize_blocks(blocks, recipe, x0)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    bits = sorted({(i, qt.bits) for i, layer in enumerate(fin)
                   for grp in layer.values() if isinstance(grp, dict)
                   for qt in _qtensors(grp)})
    got_w8 = sorted({i for i, b in bits if b == 8})
    errs = [(r.err_before, r.err_after) for r in reports]
    if got_w8 != w8_layers or not all(math.isfinite(a) and a > 0
                                      and math.isfinite(b) for a, b in errs):
        fail(f"export: W8 layers {got_w8}, errors {errs}")
    log(f"export: {len(reports)} blocks in {export_s:.2f}s")
    log("export err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    return fin, astates, export_s, errs, reports


REGIMES = tuple(f"{k}[{r}]" for k in ("dequant_matmul_w4", "dequant_matmul_w8")
                for r in ("decode", "mma"))


def require_regimes(counts, where):
    """K1 and K2 must each have run in both regimes over a path's window:
    decode from serving's decode steps, mma from prefill or the export."""
    missing = [k for k in REGIMES if counts[k] == 0]
    if missing:
        fail(f"{where} did not launch {missing}: {counts}")


def _qtensors(tree):
    from repro_torch.core.qtensor import QTensor
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)


def recheck_request0(torch, model, qparams, recipe, astates, requests, outs,
                     routes=None):
    """Request 0 again along its own greedy path, kernels (backend "auto")
    vs plain versions (backend "torch"); returns the logits of both and,
    with ``routes`` (a RouteLog class), the routing decisions of both."""
    from repro_torch.core.context import QuantCtx
    prompt, generated = requests[0][1], outs[0]
    res = {}
    for backend in ("auto", "torch"):
        ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                       backend=backend)
        if routes is None:
            res[backend] = (forced_logits(torch, model, qparams, ctx, prompt,
                                          generated, 32), None)
            continue
        with routes() as rl:
            lg = forced_logits(torch, model, qparams, ctx, prompt, generated, 32)
        res[backend] = (lg, rl.idx)
    torch.cuda.synchronize()
    lk, lt = res["auto"][0], res["torch"][0]
    rel = ((lk - lt).norm() / lt.norm()).item()
    dev = (lk - lt).abs().max().item()
    # a greedy token may differ only where the plain path's top two logits
    # lie within twice the largest deviation of each other
    near = lt.gather(1, torch.as_tensor(generated, device=DEV)[:, None])[:, 0]
    ties_ok = bool((near >= lt.max(dim=1).values - 2 * dev).all())
    agree = int((lt.argmax(dim=1).cpu() == torch.as_tensor(generated)).sum())
    return {"rel_l2": rel, "max_abs_diff": dev, "ties_ok": ties_ok,
            "greedy_agree": agree, "n_tokens": len(generated),
            "routes": (res["auto"][1], res["torch"][1])}


def path_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

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
    fin, astates, export_s, errs, _ = export(torch, model, params, calib,
                                             recipe, [0, 29])
    export_counts = ops.launch_counts()
    log(f"export launches {export_counts}")
    if export_counts["dequant_matmul_w4"] == 0 or export_counts["qmatmul_int8"] == 0:
        fail(f"export pass did not launch K1 and K3: {export_counts}")
    qparams = dict(params, layers=list(fin))
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    counts, requests, outs, stats = serve_phase(
        torch, np, model, qparams, ctx, export_counts, "smollm")
    serve_counts = stats["serve_launches"]
    if serve_counts["dequant_matmul_w4"] == 0 or serve_counts["dequant_matmul_w8"] == 0:
        fail(f"serving did not launch K1 and K2: {serve_counts}")
    require_regimes(counts, "the smollm path")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: hbm_per_slot_bytes {stats['hbm_per_slot_bytes']}, "
        f"max_memory_allocated {peak} B")

    # bf16 end to end: both paths round every matmul output and residual
    # add of 30 layers to bfloat16 (2^-9 each) in different places; a CPU
    # rehearsal of float64- vs float32-accumulated matmuls at full width
    # drifted 1.8% (relative L2). A wrong kernel is off by O(1).
    rc = recheck_request0(torch, model, qparams, recipe, astates, requests,
                          outs)
    log(f"torch backend re-run of request 0: logits relative L2 diff "
        f"{rc['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rc['max_abs_diff']:.4e}; greedy tokens {rc['greedy_agree']}/"
        f"{rc['n_tokens']} identical, the others near-ties")
    if not math.isfinite(rc["rel_l2"]) or rc["rel_l2"] > 5e-2 or not rc["ties_ok"]:
        fail("kernel and plain-version serving disagree beyond bf16 tolerance")
    rc.pop("routes")
    return counts, dict(stats, export_s=export_s, max_memory_allocated=peak,
                        err=errs, export_launches=export_counts,
                        serve_launches=serve_counts, recheck=rc)


def launcher_argv(iters: int):
    """The launcher's recipe for the trained and preemption phases:
    smollm-135m at full width and depth, W4 body, W8 layers 0 and 29, A8,
    QDrop, 64 x 64 calibration tokens (``--calib``/``--seq`` defaults), the
    launcher's lr 3e-3 and minibatches of min(16, calib) = 16."""
    return ["--arch", "smollm-135m", "--w-bits", "4", "--a-bits", "8",
            "--rule", "layers.0.*:w_bits=8", "--rule", "layers.29.*:w_bits=8",
            "--setting", "qdrop", "--iters", str(iters), "--calib", "64",
            "--seq", "64"]


def _first_curve_diff(np, a, b):
    """(report index, step) of the first loss or MSE entry that differs."""
    for i, (p, q) in enumerate(zip(a, b)):
        for x, y in ((p.loss_curve, q.loss_curve), (p.mse_curve, q.mse_curve)):
            bad = np.flatnonzero(np.asarray(x) != np.asarray(y))
            if len(bad):
                return i, int(bad[0])
    return None


def recon_graph_phase(torch, np):
    """The captured Adam step against the same body run call by call, and
    a trace of it. With the launcher's weights, calibration set and recipe
    (``launcher_argv(TRAIN_ITERS)``), blocks 0 (the W8 engine) and 1 (the
    W4 engine; its input is block 0's deployed output) of smollm-135m are
    reconstructed through ``quantize_blocks`` twice from the same seed:
    ``graphs=False``, then graphed. Loss and MSE curves, errors, the
    activation states and the exported codes, scales and zeros must be
    equal bit for bit (the first differing step is reported if not). Then
    block 1 at 20 iterations (its engine built and captured by an untraced
    run) is traced with obs.profiler: the device-busy share of its
    ``recon.chunk`` window (20 replays and the sync at their end) and the
    top 5 device ops; and its graph is replayed 20 times between CUDA
    events: the device time per step."""
    from repro_torch.configs import get_config
    from repro_torch.core import reconstruct as rc
    from repro_torch.core.context import QuantCtx
    from repro_torch.data import CalibrationSet, SyntheticTokens
    from repro_torch.launch import quantize as launcher
    from repro_torch.models.model import build_model
    from repro_torch.obs import compile_events, profiler

    args = launcher.build_parser().parse_args(launcher_argv(TRAIN_ITERS))
    recipe = launcher.build_recipe(args)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    calib = torch.as_tensor(CalibrationSet.build(SyntheticTokens(
        vocab=cfg.vocab, seq_len=args.seq, seed=0), args.calib).tokens).to(DEV)
    x0, blocks, _ = model.quant_blocks(params, calib)
    runs, res = {}, {}
    for graphs, tag in ((False, "eager"), (None, "graph")):
        rc.reset_engine_stats()
        n_caps = len(compile_events.capture_seconds("recon.step"))
        t0 = time.perf_counter()
        runs[tag] = rc.quantize_blocks(blocks[:2], recipe, x0, graphs=graphs)
        torch.cuda.synchronize()
        st = rc.engine_stats()
        reps = runs[tag][2]
        caps = compile_events.capture_seconds("recon.step")[n_caps:]
        res[tag] = {"seconds": time.perf_counter() - t0,
                    "steps_per_s": [r.steps_per_s for r in reps],
                    "engine_stats": dataclasses.asdict(st),
                    "capture_s": caps}
        log(f"recon graphs [{tag}]: blocks 0-1 in {res[tag]['seconds']:.2f}s, "
            "steps/s " + " ".join(f"{v:.1f}" for v in res[tag]["steps_per_s"])
            + f"; step captures {len(caps)} "
            f"({' '.join(f'{c:.3f}s' for c in caps)}), engines "
            f"{st.engine_builds} built")
        if st.engine_builds != 2 or st.step_compiles != len(caps) or \
                len(caps) != (2 if graphs is None else 0) or \
                any(r.engine != tag for r in reps):
            fail(f"recon graphs [{tag}]: {st}, captures {caps}, engines "
                 f"{[r.engine for r in reps]}")
    (fe, ae, re_), (fg, ag, rg) = runs["eager"], runs["graph"]
    diff = (_same_tree(torch, fe, fg, "finalized")
            + _same_tree(torch, ae, ag, "astates"))
    errs = [(r.err_before, r.err_after) for r in re_]
    if [(r.err_before, r.err_after) for r in rg] != errs:
        diff.append("errors")
    step = _first_curve_diff(np, re_, rg)
    log(f"recon graphs: graphed against graphs=False, blocks 0-1 x "
        f"{recipe.iters} steps: {len(diff)} tensors differ, first curve "
        f"difference {step}; errors {errs}")
    if diff or step is not None:
        fail(f"recon graphs: the replayed step differs from the eager one: "
             f"{diff[:10]}, first curve difference (block, step) {step}")

    # 20 replayed steps of block 1's engine (the W4 body's), the teacher
    # stream as its input
    with torch.no_grad():
        x1 = blocks[0].apply(blocks[0].params, x0, QuantCtx(mode="fp"))
        y1 = blocks[1].apply(blocks[1].params, x1, QuantCtx(mode="fp"))
    steps = 20
    r20 = dataclasses.replace(recipe, iters=steps)
    rc.clear_engine_cache()
    _, _, warm = rc.reconstruct_block(blocks[1], r20, x1, y1, chunk=steps)
    eng = next(reversed(rc._ENGINE_CACHE.values()))
    d = RUNS_DIR / "profile_recon"
    shutil.rmtree(d, ignore_errors=True)
    with profiler.trace(str(d)):
        _, _, traced = rc.reconstruct_block(blocks[1], r20, x1, y1,
                                            chunk=steps)
    win = device_window(d, "recon.chunk")
    eng.step_t.zero_()  # 20 more replays stay inside the tables
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        eng.graph.replay()
    end.record()
    end.synchronize()
    graph_ms = start.elapsed_time(end) / steps
    rc.clear_engine_cache()
    prof = dict(win, steps=steps, graph_ms_per_step=graph_ms,
                untraced_steps_per_s=warm.steps_per_s,
                traced_steps_per_s=traced.steps_per_s)
    share = win["device_busy_share"]
    log(f"profile [recon step]: {steps} replayed steps of block 1, window "
        f"{win['window_ms']:.3f} ms, device busy {win['device_busy_ms']:.3f} "
        f"ms ({'not measured' if share is None else f'{100 * share:.1f}%'}), "
        f"{win['device_ops']} device ops ({win['device_ops'] / steps:.0f} per "
        f"step); the graph's device time per step {graph_ms:.3f} ms (CUDA "
        f"events, 20 replays); steps/s untraced {warm.steps_per_s:.1f}, "
        f"traced {traced.steps_per_s:.1f}; top 5: "
        + "; ".join(f"{t['name'][:60]} {t['ms']:.3f} ms" for t in win["top5"]))
    return dict(res, errors=errs, profile=prof)


def trained_phase(torch, np, export_only_errs, path_serve_counts):
    """smollm-135m through the PTQ launcher, in process:
    ``repro_torch.launch.quantize.main`` with ``launcher_argv(TRAIN_ITERS)``,
    per-block checkpoints (``--resume-dir``), the export (``--out``) and the
    scheduler's serve run (``--serve``: 8 requests x 16 new tokens on 4
    slots, int8 KV, through the graphed engine). The launch counters are
    zeroed before the call; the launcher's ``serve_engine_run`` is wrapped
    to read them where the export ends and serving begins. The engine keeps
    its warm-up and capture out of the counters, so serving must launch
    what the export-only path's graphed serving run did, kernel by kernel
    and regime by regime (the same requests at the same shapes)."""
    from repro_torch.core import reconstruct as rc
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as launcher
    from repro_torch.obs import compile_events

    marks = {}
    real_serve = launcher.serve_engine_run
    n_caps = len(compile_events.capture_seconds("recon.step"))

    def serve_engine_run(*args, **kwargs):
        torch.cuda.synchronize()
        marks["export"] = ops.launch_counts()
        marks["export_s"] = time.perf_counter() - t0
        return real_serve(*args, **kwargs)

    argv = launcher_argv(TRAIN_ITERS) + [
        "--resume-dir", str(RUNS_DIR / "trained_ckpt"),
        "--out", str(RUNS_DIR / "trained_export"), "--serve"]
    log("trained: python -m repro_torch.launch.quantize " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    launcher.serve_engine_run = serve_engine_run
    try:
        ops.reset_launch_counts()  # the trained path's run starts here
        t0 = time.perf_counter()
        res = launcher.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()  # the trained path's run ends here
        launcher_s = time.perf_counter() - t0
    finally:
        launcher.serve_engine_run = real_serve
    export_counts, export_s = marks["export"], marks["export_s"]
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    peak = torch.cuda.max_memory_allocated()
    reports = res.reports
    errs = [(r.err_before, r.err_after) for r in reports]
    n_layers = res.cfg.n_layers
    got_w8 = sorted(i for i, layer in enumerate(res.qparams["layers"])
                    if any(qt.bits == 8 for qt in _qtensors(layer)))
    if got_w8 != [0, n_layers - 1] or len(reports) != n_layers or \
            res.resumed_units:
        fail(f"trained: W8 layers {got_w8}, {len(reports)} reports, "
             f"{res.resumed_units} resumed")
    steps = sum(r.iters for r in reports)
    loop_s = sum(r.iters / r.steps_per_s for r in reports)
    log(f"trained: launcher {launcher_s:.2f}s, {steps} steps, export (to the "
        f"serve run) {export_s:.2f}s, {loop_s:.2f}s in the Adam loops, "
        f"{steps / loop_s:.1f} steps/s, peak {peak} B")
    st = rc.engine_stats()  # the launcher zeroed it before its run
    caps = compile_events.capture_seconds("recon.step")[n_caps:]
    engine = dict(dataclasses.asdict(st), compile_count=st.compile_count)
    log(f"trained engine: {engine}; step captures "
        f"{' '.join(f'{c:.3f}s' for c in caps)}")
    if st.step_compiles != 2 or st.engine_builds != 2 or len(caps) != 2 or \
            any(r.engine != "graph" for r in reports):
        fail(f"trained: the launcher's reconstruction did not replay two "
             f"captured steps (W8 layers 0/{n_layers - 1}, W4 body): {st}, "
             f"captures {caps}, engines {[r.engine for r in reports]}")
    log("trained seconds/steps_per_s per block: " + " ".join(
        f"{r.seconds:.3f}/{r.steps_per_s:.1f}" for r in reports))
    log(f"trained export launches {export_counts}")
    if export_counts["dequant_matmul_w4"] == 0 or export_counts["qmatmul_int8"] == 0:
        fail(f"trained export did not launch K1 and K3: {export_counts}")
    before = sum(a for a, _ in errs)
    after = sum(b for _, b in errs)
    baseline = sum(b for _, b in export_only_errs)
    log("trained err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"trained: sum of err_before {before:.6e}, sum of err_after "
        f"{after:.6e}; export-only sum of err_after {baseline:.6e}")
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in errs) or not (
            after < before and after < baseline):
        fail("training did not lower the reconstruction error below its own "
             "start and the export-only run's")

    served = res.serve
    st, outs = served["stats"], served["outputs"]
    requests = [(r.rid, r.tokens, r.max_new) for r in served["requests"]]
    if sorted(outs) != list(range(8)) or any(
            len(v) != 16 or min(v) < 0 or max(v) >= res.cfg.vocab
            for v in outs.values()):
        fail(f"trained serve: bad outputs {outs}")
    n_tok = sum(len(v) for v in outs.values())
    rq = st["requests"]
    stats = {"serve_s": served["seconds"],
             "tokens_per_s": n_tok / served["seconds"],
             "decode_steps": st["decode_steps"],
             "decode_ms_per_step": rq["decode_step_us"]["mean"] / 1e3,
             "prefill_us": st["prefill_us"], "prefill_calls": st["prefill_calls"],
             "ttft_us": rq["ttft_us"], "queue_wait_us": rq["queue_wait_us"],
             "hbm_per_slot_bytes": st["hbm_per_slot_bytes"],
             "compile_count": st["compile_count"],
             "compile_us": st["compile_us"],
             "build_launches": st["build_launches"]}
    log(f"trained serve (scheduler): {n_tok} tokens in {served['seconds']:.3f}s"
        f" -> {stats['tokens_per_s']:.1f} tokens/s, {st['decode_steps']} "
        f"decode steps of {stats['decode_ms_per_step']:.2f} ms (mean), ttft "
        f"p50 {rq['ttft_us']['p50'] / 1e3:.2f} ms")
    log(f"trained serve launches {serve_counts}; compile_count "
        f"{st['compile_count']}, compile_us "
        f"{ {k: round(v) for k, v in st['compile_us'].items()} }; warm-up and "
        f"capture (not counted) {st['build_launches']}")
    if serve_counts["dequant_matmul_w4"] == 0 or serve_counts["dequant_matmul_w8"] == 0:
        fail(f"serving the trained weights did not launch K1 and K2: "
             f"{serve_counts}")
    if st["compile_count"] != 4 or serve_counts != path_serve_counts:
        fail(f"trained serve: compile_count {st['compile_count']}, launches "
             f"{serve_counts} against the export-only path's graphed "
             f"serving {path_serve_counts}")
    rc = recheck_request0(torch, res.model, res.qparams, res.recipe,
                          res.astates, requests, outs)
    rc.pop("routes")
    log(f"trained: torch backend re-run of request 0: logits relative L2 "
        f"diff {rc['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rc['max_abs_diff']:.4e}; greedy tokens {rc['greedy_agree']}/"
        f"{rc['n_tokens']} identical")
    if not math.isfinite(rc["rel_l2"]) or rc["rel_l2"] > 5e-2 or not rc["ties_ok"]:
        fail("trained: kernel and plain-version serving disagree beyond bf16 "
             "tolerance")
    recipe = res.recipe
    return counts, dict(
        stats, argv=argv,
        recipe={"setting": recipe.setting, "iters": recipe.iters,
                "lr": recipe.lr, "batch_size": recipe.batch_size,
                "calib": [64, 64]},
        launcher_s=launcher_s, export_s=export_s, loop_s=loop_s, steps=steps,
        steps_per_s=steps / loop_s, max_memory_allocated=peak,
        engine_stats=engine, step_capture_s=caps,
        err=errs, err_before_sum=before, err_after_sum=after,
        export_only_err_after_sum=baseline,
        blocks=[{"name": r.name, "seconds": r.seconds,
                 "steps_per_s": r.steps_per_s, "err_before": r.err_before,
                 "err_after": r.err_after} for r in reports],
        export_launches=export_counts, serve_launches=serve_counts,
        recheck=rc)


def _same_tree(torch, a, b, where=""):
    """Paths at which two loaded exports differ (tensors bit for bit)."""
    if isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b):
        return [d for k in a for d in _same_tree(torch, a[k], b[k],
                                                  f"{where}.{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _same_tree(torch, x, y, f"{where}[{i}]")]
    if hasattr(a, "codes") and hasattr(b, "codes"):
        same = (a.shape, a.bits, a.packed) == (b.shape, b.bits, b.packed)
        return ([] if same else [where]) + [
            d for f in ("codes", "scale", "zero")
            for d in _same_tree(torch, getattr(a, f), getattr(b, f),
                                f"{where}.{f}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.reshape(-1).view(torch.uint8)):
            return []
    elif a == b:
        return []
    return [where]


def preemption_phase(torch, np):
    """A launcher run killed mid-way resumes to the same export, bit for bit:
    (1) ``launcher_argv(PREEMPT_ITERS)`` in process, without a break, to
    export A; (2) the same command in a subprocess with ``--resume-dir D
    --out B``, sent SIGKILL once D's checkpoint records ``next_block >=
    PREEMPT_AT``; (3) the same command in process, resuming from D, to B.
    Every tensor of B (codes, scales, zeros, the fp leaves, the activation
    states) must equal A's bit for bit, and every block's err_before and
    err_after too (the killed process's blocks come from its checkpoint)."""
    import os
    import signal

    from repro_torch.checkpoint import PTQCheckpointer, load_pytree
    from repro_torch.launch import quantize as launcher

    argv = launcher_argv(PREEMPT_ITERS)
    ckpt, out_a, out_b = (str(RUNS_DIR / n) for n in
                          ("preempt_ckpt", "preempt_a", "preempt_b"))
    secs = {}
    t0 = time.perf_counter()
    res_a = launcher.main(argv + ["--out", out_a])
    torch.cuda.synchronize()
    secs["uninterrupted"] = time.perf_counter() - t0

    log_path = RUNS_DIR / "preempt_child.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.quantize"] + argv + [
        "--resume-dir", ckpt, "--out", out_b]
    t0 = time.perf_counter()
    with open(log_path, "w") as fh:
        child = subprocess.Popen(cmd, env=env, stdout=fh,
                                 stderr=subprocess.STDOUT, cwd=str(ROOT))
        try:
            killed_at = None
            while child.poll() is None and time.perf_counter() - t0 < 300:
                try:
                    meta = PTQCheckpointer(ckpt).meta()
                except (OSError, ValueError):  # caught mid-commit: poll again
                    meta = None
                if meta is not None and meta["next_block"] >= PREEMPT_AT:
                    child.send_signal(signal.SIGKILL)
                    killed_at = meta["next_block"]
                    break
                time.sleep(0.02)
        finally:
            if child.poll() is None and killed_at is None:
                child.kill()
            child.wait()
    secs["killed_child"] = time.perf_counter() - t0
    tail = log_path.read_text()[-3000:]
    if killed_at is None or child.returncode != -signal.SIGKILL:
        fail(f"preemption: the child was not killed mid-run (exit "
             f"{child.returncode}, next_block {killed_at}):\n{tail}")
    saved = PTQCheckpointer(ckpt).meta()["next_block"]
    log(f"preemption: child killed at next_block {killed_at} (checkpoint "
        f"holds {saved}) after {secs['killed_child']:.2f}s")

    t0 = time.perf_counter()
    res_b = launcher.main(argv + ["--resume-dir", ckpt, "--out", out_b])
    torch.cuda.synchronize()
    secs["resumed"] = time.perf_counter() - t0
    if res_b.resumed_units != saved:
        fail(f"preemption: resumed {res_b.resumed_units} blocks, the "
             f"checkpoint held {saved}")
    tree_a, _ = load_pytree(out_a, device=DEV)
    tree_b, _ = load_pytree(out_b, device=DEV)
    diff = _same_tree(torch, tree_a, tree_b)
    errs_a = [(r.err_before, r.err_after) for r in res_a.reports]
    errs_b = [(r.err_before, r.err_after) for r in res_b.reports]
    bad = [i for i, (x, y) in enumerate(zip(errs_a, errs_b)) if x != y]
    log(f"preemption: uninterrupted {secs['uninterrupted']:.2f}s, killed "
        f"child {secs['killed_child']:.2f}s, resumed {secs['resumed']:.2f}s "
        f"({res_b.resumed_units} blocks from the checkpoint); exports differ "
        f"at {len(diff)} tensors, per-block errors at {len(bad)} blocks")
    n_layers = res_a.cfg.n_layers
    engines = {r.engine for r in res_a.reports + res_b.reports}
    if engines != {"graph"}:
        fail(f"preemption: the runs did not replay captured steps: {engines}")
    if diff or bad or len(errs_a) != n_layers or len(errs_b) != n_layers:
        fail(f"preemption: the resumed export differs from the uninterrupted "
             f"one: tensors {diff[:10]}, blocks {bad}")
    return dict(seconds=secs, killed_at=killed_at, resumed_blocks=saved,
                iters=PREEMPT_ITERS, err=errs_a,
                err_after_sum=sum(b for _, b in errs_a))


# -------------------------------------------------------------- auto-bits
class _Tee:
    """A stdout that also keeps what was written (the launcher's prints)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def _site_qtensors(model, layers):
    """{site name: exported leaf} over the layers, named and found as
    ``quant_blocks`` names and finds the sites (``layers.<i>.wq`` at
    ``("attn", "wq")``), so the names are the allocation's."""
    from repro_torch.core import paths as pth
    sites = model._layer_sites(model.kind)
    return {name.replace("layers", f"layers.{i}", 1):
            pth.get_path(layer, site.path)
            for i, layer in enumerate(layers) for name, site in sites.items()}


def check_low_bit_site(torch, name, qt, M, gen):
    """One exported 2- or 3-bit QTensor through the deploy dispatch
    (``ops.qtensor_matmul``, backend "auto") against the plain version
    (backend "torch") on the same bf16 x: the dispatch must take K1, in
    the regime its planner picks, within the kernels phase's bf16
    tolerance."""
    from repro_torch.kernels import dequant_matmul_w4 as k12
    from repro_torch.kernels import ops
    K, N = qt.shape
    x = torch.randn((M, K), generator=gen, device=DEV).to(torch.bfloat16)
    fn = k12.dequant_matmul_w4
    forms = dict(fn.forms)
    got = ops.qtensor_matmul(x, qt)
    kernel = ops.last_kernel
    took = [f for f in forms if fn.forms[f] != forms[f]]
    want = ops.qtensor_matmul(x, qt, backend="torch")
    torch.cuda.synchronize()
    p = k12.plan(M, K, N, x.dtype, True, x.data_ptr(), qt.codes.data_ptr())
    if kernel != "dequant_matmul_w4" or took != [p.regime]:
        fail(f"auto-bits: {name} (w{qt.bits}) at M={M} went to {kernel} "
             f"{took}, planned K1 {p.regime}")
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or not bool(
            (err <= _matmul_tol(torch, x, None, want, K)).all()):
        fail(f"auto-bits: {name} (w{qt.bits}) at M={M}: K1 against the plain "
             f"version max |err| {err.max().item():.3e}")
    return {"kernel": "dequant_matmul_w4", "site": name, "bits": qt.bits,
            "M": M, "K": K, "N": N, "x": "bfloat16", "regime": p.regime,
            "max_abs_err": err.max().item()}


def auto_bits_phase(torch, np, trained):
    """smollm-135m through the launcher with automatic bit allocation, in
    process: ``launcher_argv(AUTO_ITERS) + --auto-bits AUTO_BITS
    --resume-dir D --out O --serve`` (run 1, the counted window), the same
    command again (run 2: the recorded allocation reused, every block
    resumed) and ``--auto-bits AUTO_BITS_OTHER`` against D (run 3: refused).
    Returns (launch counts of run 1, K1 rows of the 2-/3-bit checks,
    stats)."""
    from repro_torch import allocate
    from repro_torch.allocate import AllocationReport, validate_budget
    from repro_torch.checkpoint import load_pytree
    from repro_torch.core import reconstruct as rc
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as launcher
    from repro_torch.obs import compile_events

    ckpt, out = str(RUNS_DIR / "auto_ckpt"), str(RUNS_DIR / "auto_export")
    argv = launcher_argv(AUTO_ITERS) + [
        "--auto-bits", AUTO_BITS, "--resume-dir", ckpt, "--out", out,
        "--serve"]
    log("auto-bits: python -m repro_torch.launch.quantize " + " ".join(argv))
    marks, probes = {}, []
    real_serve, real_probe = launcher.serve_engine_run, allocate.probe_blocks

    def serve_engine_run(*args, **kwargs):
        torch.cuda.synchronize()
        marks["export"] = ops.launch_counts()
        marks["export_s"] = time.perf_counter() - t0
        return real_serve(*args, **kwargs)

    def probe_blocks(*args, **kwargs):
        probes.append(real_probe(*args, **kwargs))
        return probes[-1]

    n_probe_caps = len(compile_events.capture_seconds("alloc.probe"))
    n_step_caps = len(compile_events.capture_seconds("recon.step"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launcher.serve_engine_run = serve_engine_run
    allocate.probe_blocks = probe_blocks
    tee = _Tee(sys.stdout)
    try:
        sys.stdout = tee
        ops.reset_launch_counts()  # the auto-bits path's run starts here
        t0 = time.perf_counter()
        res = launcher.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()  # the auto-bits path's run ends here
        launcher_s = time.perf_counter() - t0
    finally:
        sys.stdout = tee.out
        launcher.serve_engine_run = real_serve
        allocate.probe_blocks = real_probe
    export_counts, export_s = marks["export"], marks["export_s"]
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    # a copy: the run-2 launcher zeroes the live counters in place
    st = dataclasses.replace(rc.engine_stats())
    engine = dict(dataclasses.asdict(st), compile_count=st.compile_count)
    probe_caps = compile_events.capture_seconds("alloc.probe")[n_probe_caps:]
    step_caps = compile_events.capture_seconds("recon.step")[n_step_caps:]
    n_layers = res.cfg.n_layers

    # the allocation: recorded, within its budget, more than one width
    report = AllocationReport.load(ckpt)
    if report is None or len(probes) != 1:
        fail(f"auto-bits: no allocation recorded in {ckpt} or "
             f"{len(probes)} probe passes")
    probe = probes[0]
    bits = report.bits()
    widths = sorted(set(bits.values()))
    hist = {b: sum(v == b for v in bits.values()) for b in widths}
    log("auto-bits allocation: " + report.pretty().splitlines()[0]
        + f" sites per width {hist}; "
        + " ".join(report.pretty().splitlines()[-2:]).strip())
    paths = sorted({n.split(".", 2)[2] for n in bits})
    log("auto-bits bits per layer: " + " ".join(
        "".join(str(bits.get(f"layers.{i}.{p}", "?")) for p in paths)
        for i in range(n_layers)) + f" (sites {paths})")
    if not validate_budget(report) or report.summary["avg_bits"] > float(
            AUTO_BITS) or len(widths) < 2 or res.allocation != report.meta():
        fail(f"auto-bits: allocation {report.summary} over its budget, "
             f"widths {widths}, or not the run's ({res.allocation})")
    if len(bits) != 7 * n_layers:
        fail(f"auto-bits: {len(bits)} sites allocated, {7 * n_layers} exist")
    # the export carries the allocated bits; <= 4 bits nibble-packed
    layers = res.qparams["layers"]
    sites = _site_qtensors(res.model, layers)
    n_qt = sum(1 for layer in layers for _ in _qtensors(layer))
    wrong = [(n, getattr(qt, "bits", None), bits.get(n))
             for n, qt in sites.items()
             if not hasattr(qt, "codes") or qt.bits != bits.get(n)
             or (qt.bits <= 4 and not (qt.packed and qt.pack_axis == 0))
             or int(qt.unpacked_codes().max()) > 2**qt.bits - 1]
    if sorted(sites) != sorted(bits) or n_qt != len(sites) or wrong:
        fail(f"auto-bits: export sites differ from the allocation or are "
             f"stored wrong: {wrong[:5]}")

    # the probe, the engines, the errors
    log(f"auto-bits probe: {probe.steps} probes in {probe.seconds:.3f}s "
        f"({probe.steps_per_s:.1f}/s), probe_compiles {st.probe_compiles}, "
        f"{len(probe_caps)} alloc.probe captures of "
        f"{sum(probe_caps):.3f}s ({' '.join(f'{c:.3f}' for c in probe_caps)})"
        f"; rtn.init (the mse observer, {probe.steps} inits) "
        f"{probe.init_seconds:.3f}s, replays (each read back) "
        f"{probe.replay_seconds:.3f}s, the rest (teacher, capture pass, "
        f"captures, fisher) "
        f"{probe.seconds - probe.init_seconds - probe.replay_seconds:.3f}s")
    if st.probe_compiles != len(probe_caps) or not 0 < st.probe_compiles <= 8 \
            or probe.steps != 4 * 7 * n_layers:
        fail(f"auto-bits: {st.probe_compiles} probe bodies, "
             f"{len(probe_caps)} captures, {probe.steps} probes")
    reports = res.reports
    errs = [(r.err_before, r.err_after) for r in reports]
    before, after = sum(a for a, _ in errs), sum(b for _, b in errs)
    steps = sum(r.iters for r in reports)
    loop_s = sum(r.iters / r.steps_per_s for r in reports)
    log(f"auto-bits: launcher {launcher_s:.2f}s (probe {probe.seconds:.2f}s,"
        f" export to the serve run {export_s:.2f}s), {steps} steps, "
        f"{loop_s:.2f}s in the Adam loops, {steps / loop_s:.1f} steps/s; "
        f"max_memory_allocated {peak} B, max_memory_reserved {peak_reserved} B")
    log(f"auto-bits engine: {engine}; engines {st.engine_builds} built, "
        f"{st.engine_hits} reused; {len(step_caps)} step captures of "
        f"{sum(step_caps):.3f}s ({' '.join(f'{c:.3f}' for c in step_caps)})")
    if st.step_compiles != st.engine_builds or len(step_caps) != \
            st.engine_builds or st.engine_builds + st.engine_hits != n_layers \
            or any(r.engine != "graph" for r in reports) or res.resumed_units:
        fail(f"auto-bits: the reconstruction did not replay one captured "
             f"step per engine: {st}, {len(step_caps)} captures, engines "
             f"{[r.engine for r in reports]}, {res.resumed_units} resumed")
    log("auto-bits err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"auto-bits: sum of err_before {before:.6e}, sum of err_after "
        f"{after:.6e}; trained phase (W4 body, W8 layers 0/29): "
        f"{trained['err_before_sum']:.6e} -> {trained['err_after_sum']:.6e}")
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in errs) or \
            not after < before:
        fail("auto-bits: training did not lower the reconstruction error")

    # launches: K1 on every packed width, K3 and K2 where sites are 8-bit
    log(f"auto-bits export launches {export_counts}")
    log(f"auto-bits serve launches {serve_counts}")
    need = ["dequant_matmul_w4"] + (["qmatmul_int8"] if 8 in widths else [])
    if any(export_counts[k] == 0 for k in need) or \
            serve_counts["dequant_matmul_w4"] == 0 or \
            (8 in widths and serve_counts["dequant_matmul_w8"] == 0):
        fail(f"auto-bits: export {export_counts}, serve {serve_counts}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    low = {b: [n for n in sorted(sites) if sites[n].bits == b] for b in (2, 3)}
    if not all(low.values()):
        fail(f"auto-bits: the allocation put no site at 2 or 3 bits ({hist});"
             f" K1 cannot be held at those widths on the export")
    for b, names in low.items():
        for M in (4, 512):
            rows.append(check_low_bit_site(torch, names[-1], sites[names[-1]],
                                           M, gen))
    log("auto-bits K1 on the export's low-bit sites: " + "; ".join(
        f"{r['site']} w{r['bits']} M={r['M']} {r['regime']} "
        f"max|err| {r['max_abs_err']:.3e}" for r in rows))

    # serving through the scheduler, and request 0 on the plain versions
    served = res.serve
    sst, outs = served["stats"], served["outputs"]
    requests = [(r.rid, r.tokens, r.max_new) for r in served["requests"]]
    if sorted(outs) != list(range(8)) or any(
            len(v) != 16 or min(v) < 0 or max(v) >= res.cfg.vocab
            for v in outs.values()) or sst["compile_count"] != 4:
        fail(f"auto-bits serve: outputs {outs}, compile_count "
             f"{sst['compile_count']}")
    n_tok = sum(len(v) for v in outs.values())
    rq = sst["requests"]
    serve = {"serve_s": served["seconds"],
             "tokens_per_s": n_tok / served["seconds"],
             "decode_steps": sst["decode_steps"],
             "decode_ms_per_step": rq["decode_step_us"]["mean"] / 1e3,
             "ttft_us": rq["ttft_us"], "compile_count": sst["compile_count"]}
    log(f"auto-bits serve (scheduler): {n_tok} tokens in "
        f"{served['seconds']:.3f}s -> {serve['tokens_per_s']:.1f} tokens/s, "
        f"{sst['decode_steps']} decode steps of "
        f"{serve['decode_ms_per_step']:.2f} ms (mean); trained phase "
        f"{trained['tokens_per_s']:.1f} tokens/s, "
        f"{trained['decode_ms_per_step']:.2f} ms")
    rc0 = recheck_request0(torch, res.model, res.qparams, res.recipe,
                           res.astates, requests, outs)
    rc0.pop("routes")
    log(f"auto-bits: torch backend re-run of request 0: logits relative L2 "
        f"diff {rc0['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rc0['max_abs_diff']:.4e}; greedy tokens {rc0['greedy_agree']}/"
        f"{rc0['n_tokens']} identical")
    if not math.isfinite(rc0["rel_l2"]) or rc0["rel_l2"] > 5e-2 or \
            not rc0["ties_ok"]:
        fail("auto-bits: kernel and plain-version serving disagree beyond "
             "bf16 tolerance")

    # run 2: the same command reuses the allocation and resumes every block
    tree1, _ = load_pytree(out, device=DEV)
    del res, sites
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        sys.stdout = tee
        res2 = launcher.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = tee.out
    rerun_s = time.perf_counter() - t0
    st2 = rc.engine_stats()
    tree2, _ = load_pytree(out, device=DEV)
    diff = _same_tree(torch, tree1, tree2)
    reused = "reusing recorded allocation" in tee.text()
    log(f"auto-bits run 2: {rerun_s:.2f}s, allocation reused {reused}, "
        f"probe_compiles {st2.probe_compiles}, {res2.resumed_units} blocks "
        f"resumed, export differs from run 1 at {len(diff)} tensors")
    if not reused or st2.probe_compiles or res2.resumed_units != n_layers \
            or diff or res2.allocation != report.meta():
        fail(f"auto-bits run 2: reused {reused}, {st2}, resumed "
             f"{res2.resumed_units}, differs at {diff[:5]}")
    del res2, tree1, tree2

    # run 3: another budget against the recorded allocation is refused
    other = [a if a != AUTO_BITS else AUTO_BITS_OTHER for a in argv]
    try:
        launcher.main(other)
    except ValueError as e:
        refused = str(e)
    else:
        fail("auto-bits run 3: --auto-bits 4.0 against the recorded 4.5 "
             "allocation was not refused")
    if "holds allocation" not in refused or "but this run requests" \
            not in refused:
        fail(f"auto-bits run 3: refused with another message: {refused}")
    log(f"auto-bits run 3 refused: {refused[:160]}...")

    return counts, rows, dict(
        argv=argv, launcher_s=launcher_s, export_s=export_s,
        probe={"steps": probe.steps, "seconds": probe.seconds,
               "steps_per_s": probe.steps_per_s,
               "init_seconds": probe.init_seconds,
               "replay_seconds": probe.replay_seconds,
               "probe_compiles": st.probe_compiles,
               "capture_s": probe_caps},
        allocation={"summary": report.summary, "solver": report.solver,
                    "digest": report.digest(), "sites_per_width": hist},
        engine_stats=engine, step_capture_s=step_caps, loop_s=loop_s,
        steps=steps, steps_per_s=steps / loop_s,
        max_memory_allocated=peak, max_memory_reserved=peak_reserved,
        err=errs, err_before_sum=before, err_after_sum=after,
        export_launches=export_counts, serve_launches=serve_counts,
        serve=serve, recheck=rc0, rerun_s=rerun_s, refused=refused)


# ----------------------------------------------------------------- MoE path
class RouteLog:
    """Records the top-k expert indices of every ``moe.route`` call made
    inside the ``with`` block (``moe_ffn`` looks ``route`` up at call
    time)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.idx = moe, moe.route, []

        def route(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.idx.append(out[1])
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def k4_entry_phase(torch, model, params, calib, recipe):
    """K4 behind its entry point: ``ops.flexround_fake_quant`` on every 2-D
    site of layer 0, with the fp weights and the states ``flexround.init``
    gives under the path's recipe. Counters are zeroed just before and read
    just after; then each output must equal the plain version bit for bit."""
    from repro_torch.core import paths as pth
    from repro_torch.kernels import ops
    _, blocks, _ = model.quant_blocks(params, calib[:1])
    block = blocks[0]
    sites = [(n, s) for n, s in block.sites.items() if s.batch_dims == 0]
    plans = [recipe.resolve(n, s) for n, s in sites]
    ws = [pth.get_path(block.params, s.path) for _, s in sites]
    states = [p.method.init(w, p.weight) for p, w in zip(plans, ws)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # K4's run through its entry point starts here
    outs = [ops.flexround_fake_quant(w, st, p.weight)
            for w, st, p in zip(ws, states, plans)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # ... and ends here
    if counts["flexround_quant"] != len(sites):
        fail(f"K4 launched {counts['flexround_quant']} times for "
             f"{len(sites)} sites")
    for (name, _), w, st, p, got in zip(sites, ws, states, plans, outs):
        want = ops.flexround_fake_quant(w, st, p.weight, backend="torch")
        if got.dtype != w.dtype or not torch.equal(got, want):
            fail(f"K4 on {name} {tuple(w.shape)}: not bit-exact against the "
                 "plain version")
    log(f"K4 entry point: {len(sites)} sites of layer 0 "
        f"({', '.join(n.split('.', 2)[2] for n, _ in sites)}), "
        f"{plans[0].weight.bits}-bit, bit-exact; launches {counts}")
    return counts


def moe_block_check(torch, model, qparams, recipe, astates, calib):
    """One MoE FFN of a W8 layer (unpacked K5) and of a W4 layer (packed
    K5), each fed the same hidden input in deploy mode with backend "auto"
    (kernels) and "torch" (plain versions): the routing must be identical
    (the router is float32 and reads the same input) and the outputs agree
    within bfloat16 tolerance."""
    from repro_torch.core.context import QuantCtx
    from repro_torch.models import common, moe
    cfg = model.cfg
    x = common.embed_tokens(qparams["embed"], calib[:2], cfg.emb_mult)
    pos = torch.arange(x.shape[1], device=DEV)[None]
    sin, cos = common.rope_sin_cos(pos, cfg.head_dim, cfg.rope_theta)
    ctxs = {b: QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                        backend=b) for b in ("auto", "torch")}
    res = []
    for li in (0, 1):
        p = qparams["layers"][li]
        name = f"layers.{li}"
        h = common.apply_norm(cfg.norm, x, p.get("ln2"))
        ys, idx = {}, {}
        for b, ctx in ctxs.items():
            with RouteLog() as rl:
                y, _ = moe.moe_ffn(p["mlp"], h, cfg, ctx, name)
            ys[b], idx[b] = y.float(), rl.idx[0]
        torch.cuda.synchronize()
        same_route = torch.equal(idx["auto"], idx["torch"])
        rel = ((ys["auto"] - ys["torch"]).norm() / ys["torch"].norm()).item()
        dev = (ys["auto"] - ys["torch"]).abs().max().item()
        bits = p["mlp"]["experts"]["w_up"].bits
        log(f"MoE block check, layer {li} (W{bits}): {idx['auto'].numel()} "
            f"routing decisions identical: {same_route}; output relative L2 "
            f"{rel:.4e} (tolerance 2e-2), max |diff| {dev:.4e}")
        # both sides round each of the three expert matmuls and the shared
        # expert's to bfloat16 in different places: a few bf16 steps
        # (2^-8 relative) per element; a wrong kernel is off by O(1)
        if not same_route or not math.isfinite(rel) or rel > 2e-2:
            fail(f"MoE block {li}: kernel and plain version disagree")
        res.append({"layer": li, "bits": bits, "routing_identical": same_route,
                    "rel_l2": rel, "max_abs_diff": dev})
        x = model.layer_apply(p, x, ctxs["auto"], name, sin, cos)[0]
    return res


def moe_path_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=LLAMA4_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 64)), device=DEV)
    last = LLAMA4_LAYERS - 1
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_granularity="per_channel", w_observer="mse",
                         iters=0, rules=("layers.0.*:w_bits=8",
                                         f"layers.{last}.*:w_bits=8"))
    torch.cuda.synchronize()
    log(f"MoE path: {cfg.name} ({cfg.n_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab}, {cfg.dtype}) initialised in "
        f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated()} B")

    k4_counts = k4_entry_phase(torch, model, params, calib, recipe)

    ops.reset_launch_counts()  # the MoE main path's run starts here
    fin, astates, export_s, errs, _ = export(torch, model, params, calib,
                                             recipe, [0, last])
    export_counts = ops.launch_counts()
    log(f"export launches {export_counts}")
    qparams = dict(params, layers=list(fin))
    del params  # the bf16 expert stacks; qparams holds the QTensors
    gc.collect()
    torch.cuda.empty_cache()
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    counts, requests, outs, stats = serve_phase(
        torch, np, model, qparams, ctx, export_counts, "llama4")
    serve_counts = stats["serve_launches"]
    need = {"export: K5 packed": export_counts["dequant_matmul_batched[packed]"],
            "export: K5 unpacked":
                export_counts["dequant_matmul_batched[unpacked]"],
            "export: K5 mma": export_counts["dequant_matmul_batched[mma]"],
            "serve: K5 packed": serve_counts["dequant_matmul_batched[packed]"],
            "serve: K5 unpacked":
                serve_counts["dequant_matmul_batched[unpacked]"],
            "serve: K5 decode": serve_counts["dequant_matmul_batched[decode]"],
            "K1": counts["dequant_matmul_w4"], "K2": counts["dequant_matmul_w8"],
            "K3": counts["qmatmul_int8"]}
    if not all(need.values()):
        fail(f"the MoE path did not launch every kernel: {need}")
    require_regimes(counts, "the MoE path")
    peak = torch.cuda.max_memory_allocated()
    expect = 32 * cfg.n_layers * cfg.n_kv_heads * (2 * cfg.head_dim + 2 * 4)
    log(f"serve: hbm_per_slot_bytes {stats['hbm_per_slot_bytes']} (expected "
        f"{expect}), max_memory_allocated {peak} B")
    if stats["hbm_per_slot_bytes"] != expect:
        fail("hbm_per_slot_bytes differs from the int8 KV cache's size")

    blocks = moe_block_check(torch, model, qparams, recipe, astates, calib)
    rc = recheck_request0(torch, model, qparams, recipe, astates, requests,
                          outs, routes=RouteLog)
    rk, rt = rc.pop("routes")
    flips = sum(int((a != b).sum()) for a, b in zip(rk, rt))
    decisions = sum(a.numel() for a in rk)
    rc.update(routing_decisions=decisions, routing_flips=flips)
    log(f"torch backend re-run of request 0: logits relative L2 diff "
        f"{rc['rel_l2']:.4e}, max |diff| {rc['max_abs_diff']:.4e}; routing "
        f"decisions that differ {flips}/{decisions}; greedy tokens "
        f"{rc['greedy_agree']}/{rc['n_tokens']} identical")
    # 4 layers rounded to bf16 in different places drift far less than the
    # 30 of smollm (2% there); only a flipped top-1 expert at a near-tie
    # may move the logits by O(1)
    if len(rk) != len(rt) or not math.isfinite(rc["rel_l2"]) or (
            flips == 0 and rc["rel_l2"] > 5e-2):
        fail("kernel and plain-version serving disagree beyond bf16 tolerance "
             "without a routing flip")
    return counts, k4_counts, dict(
        stats, export_s=export_s, max_memory_allocated=peak, err=errs,
        export_launches=export_counts, serve_launches=serve_counts,
        k4_launches=k4_counts, block_check=blocks, recheck=rc)


def _timed_row(rows, name):
    t = TIMED[name]
    for r in rows:
        if r["kernel"] != name or "ms" not in r:
            continue
        if name == "flexround_quant":
            if (r["M"], r["N"], r["x"]) == t and r["granularity"] == "per_channel":
                return r
        elif (r["M"], r["K"], r["N"], r["x"]) == t and r.get("packed", True) \
                and r.get("E", LLAMA4_E) == LLAMA4_E \
                and r.get("x_rows", "dense") == "dense":
            return r
    fail(f"no timed row for {name} at {t}")


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

    t0 = time.perf_counter()
    rows = kernels_phase(torch)
    log(f"kernels phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts, path = path_phase(torch, np)
    log(f"smollm path phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    recon_graphs = recon_graph_phase(torch, np)
    log(f"smollm recon graphs phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained_counts, trained = trained_phase(torch, np, path["err"],
                                            path["serve_launches"])
    log(f"smollm trained phase (launcher): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    preemption = preemption_phase(torch, np)
    log(f"smollm preemption phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    auto_counts, auto_rows, auto_bits = auto_bits_phase(torch, np, trained)
    rows.extend(auto_rows)
    log(f"smollm auto-bits phase (launcher): {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_counts, k4_counts, moe_path = moe_path_phase(torch, np)
    log(f"MoE path phase: {time.perf_counter() - t0:.1f}s")

    summary = []
    for name in KERNEL_NAMES:
        timed = _timed_row(rows, name)
        src, replaces = SOURCES[name]
        by_path = {"smollm-135m": counts[name],
                   "smollm-135m-trained": trained_counts[name],
                   "smollm-135m-auto-bits": auto_counts[name],
                   "llama4-scout-17b-a16e": moe_counts[name],
                   "flexround_fake_quant": k4_counts[name]}
        shape = ({"M": timed["M"], "N": timed["N"], "w": timed["x"]}
                 if name == "flexround_quant" else
                 {"M": timed["M"], "K": timed["K"], "N": timed["N"],
                  "x": timed["x"]})
        if "E" in timed:
            shape.update(E=timed["E"], packed=timed["packed"])
        if "regime" in timed:
            shape.update(regime=timed["regime"])
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": shape, "launches_by_path": by_path,
        })
        if "kernel_ms" in timed:
            summary[-1].update(kernel_ms=timed["kernel_ms"],
                               splits=timed["splits"])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": summary, "rows": rows, "path": path,
         "recon_graphs": recon_graphs, "trained_path": trained,
         "preemption": preemption, "auto_bits_path": auto_bits,
         "moe_path": moe_path}, indent=1))
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
