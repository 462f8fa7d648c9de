#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one card of 80 GB (the deepseek-v3 path peaks below 75 GB). Phases,
each fatal on failure (the exit code is non-zero and the last line is not
printed):

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
              8192), (8192, 5120); M in {4, 16, 512}) and qwen2.5-14b's MLP
              shapes ((5120, 13824), (13824, 5120); M in {4, 512}: a
              13824-deep contraction, 6912 packed code rows), plus ragged M, N and
              K and misaligned x and codes in both regimes, x in bfloat16
              and float32; each row names the regime the call took. K3
              (qmatmul_int8) at the smollm shapes (M in {4, 64, 512}), the
              llama4 2-D and the qwen MLP shapes at M = 512 ((5120, 1024)
              splits K),
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
   Analysis — the static checks (``repro_torch.analysis.lint.run_analysis
              (mem=True, decode_smoke=True, diff_full=True, device="cuda")``):
              the AST rules over src/repro_torch; the traced-graph layers
              (QL2xx, QL301-303, QL305-306, memcheck QL4xx) over the step
              bodies traced by make_fx with fake CUDA tensors; the kernel
              coverage (every layout's kernel and regimes, the conv
              frontends' QL207 warnings) and the full QL304 lattice (136
              cells of six layouts, float32 and bfloat16): 0 errors, every
              cell's recorded (plain, kernel) pair EXPECTED_KERNELS', n_fail
              0, and K1/K2/K5 must take decode and mma in bfloat16 and fp32
              in float32; the largest error against its bound is logged per
              layout and dtype, the QL301 proof and each QL401 peak against
              its budget. Then the same check_parity at the smollm sites'
              (K, N) at M = 4 and 512 for each 2-D layout but the odd-K one,
              and K5 at llama4-scout's E = 16, K = 5120, N = 8192, M = 4, in
              bfloat16. Then the seven seeded bugs, in process, each caught
              by its rule (QL202 counting CUDA-graph captures); a 2-block
              then a 4-block toy chain with graphs on, 0 new captures; every
              entry with a memory budget replayed on the card, the caching
              allocator's peak above the inputs at most the static peak in
              512-byte blocks (``memcheck.replay_peak``); the sharded recon
              entry traced on 2 gloo ranks of the card (torchrun, this
              script's ``--analysis-mesh-child``), QL206 and QL305 quiet.
              After the smollm path (4.) serves: a second wave of its
              requests through its graphed engine inside ``no_retrace(0)``
              (0 new captures, K1 and K2 launched), and the full-width
              deploy decode and serving bodies traced from its export:
              QL403 equal to tree_weight_bytes, QL405 to
              hbm_per_slot_bytes, the decode replayed against the allocator.
              The trained launcher (5.) runs with ``--analyze-mem``.
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
              is re-run with the plain versions (5e-2 relative L2). The
              launcher writes telemetry (--telemetry TELEMETRY_DIR, under
              build/), which ``python -m repro_torch.obs.sink --validate``
              must accept (exit 0).
   Auto-bits — the trained phase's launcher command plus ``--auto-bits
              4.5`` (avg_bits budget, combined objective, AUTO_ITERS = 50
              iterations: 100 until the dry-run phase took the seconds), ``--resume-dir`` and ``--serve``: the sensitivity
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
   Olmo     — olmo-1b at full width and depth (16 layers, d_model 2048,
              16 heads = 16 KV heads, d_ff 8192, vocab 50304, untied head,
              non-parametric LayerNorm: no norm keys in its tree), bf16,
              weights from torch.Generator seed 0, through the launcher in
              process with the trained phase's command (W4 body, W8 layers
              0 and 15, A8, QDrop, OLMO_ITERS = 50 iterations, --resume-dir,
              --serve). Counters zeroed before and read after, split where
              serving starts: the export must launch K1 and K3, serving K1
              and K2; the error sum must fall below its start. Then the
              export serves the 8 requests graphed and eagerly (identical
              tokens and launches) and request 0 is re-run plain (5e-2
              relative L2). Reports the launcher's seconds, steps/s, the
              scheduler's decode ms per step and tokens/s, and
              max_memory_allocated.
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
6. Qwen path — qwen2.5-14b at full width (d_model 5120, 40 heads, 8 KV
              heads, d_ff 13824, vocab 152064, QKV biases, rope theta 1e6,
              untied head) and 4 of its 48 layers, bf16 (5.3 GB), weights
              from torch.Generator seed 0: phase 4's export-only PTQ (W4
              body, W8 layer 3, A8, mse observer) and serving runs; K1, K2
              and K3 must launch, K1 and K2 in both regimes, graphed tokens
              equal eager tokens, request 0 agrees with the plain versions.
7. Deepseek — deepseek-v3-671b at full width (d_model 7168, 128 heads, MLA
              with q rank 1536 and kv rank 512, d_ff 18432, 256 experts
              top-8 of width 2048, a shared expert, vocab 129280) and 4 of
              its 61 layers (the 3 leading dense layers and 1 MoE layer,
              30.2 GB of bf16), no mtp head, weights from torch.Generator
              seed 0: block 0 (dense MLA) reconstructed for 100 FlexRound
              iterations (W4A8, QDrop) graphed and with graphs=False, equal
              bit for bit and its error falling; export-only PTQ (W4 body,
              W8 layer 0, A8, mse observer, RTN on the expert stacks) and
              the launcher's serve_smoke (batch 2, 16 prompt tokens, 8
              steps through the absorbed decode), counters zeroed before
              and read after: K1, K2, K3 and K5 (packed, mma at the export
              and decode in serving) must launch; the prompt decoded
              greedily with the kernels and re-run along the same tokens
              with the plain versions; the slot engine and the int8 cache
              must refuse MLA; max_memory_allocated below 80 GB. Then
              ``model.loss`` with the mtp head on the reduced config
              against an unchunked float32 cross entropy, and the reduced
              config through the launcher (QDrop W4A8, --serve-smoke
              --serve; as in Preempt, a launcher subprocess SIGKILLed
              after block 0's checkpoint, resumed in process, equals an
              unbroken run bit for bit). The kernels phase adds
              K1/K2 at deepseek's 2-D sites (M 2, 32, 512), K3 at M 512 and
              K5 at E = 256 (2 tokens top-8: 16 active experts, M 4; and
              the export's M 32).
8. Whisper  — whisper-medium at full width and depth (24 encoder and 24
              decoder layers, d_model 1024, 16 heads, d_ff 4096, vocab
              51865; LayerNorm, GELU, biased projections), bf16, weights
              from torch.Generator seed 0, the audio stub's frame
              embeddings N(0, 1) from seed 1 (16 x 1504 x 1024) and 16 x 64
              calibration tokens: FlexRound (W4 body, W8 layers 0 and 23,
              A8, QDrop, minibatches of 16 = the calibration set, the limit
              the encoder output baked into every decoder block sets).
              Block 0's 20 iterations graphed against graphs=False, bit for
              bit; then, counters zeroed before and read after, all 24
              decoder blocks at WHISPER_ITERS = 40 through the captured engine
              (the error sum must fall; the export must launch K1 in the
              mma regime and K3) and uniform-batch serving (batch 4, 16
              prompt tokens, 16 greedy steps over 1504 frames) with the
              int8 self and cross caches and with bf16 ones (µs per step,
              cache bytes: int8 must be smaller); K1 and K2 in both
              regimes; every (M, K, N) the window gave K1, K2 or K3 is
              held against its plain version (``check_path_shapes``).
              Request 0 re-run along its path with the plain versions; the
              slot engine must refuse the family
              (``unsupported_family:encdec``); 8 int8-cache decode steps
              traced (device-busy share).
9. Mamba2   — mamba2-130m at full width and depth (24 layers, d_model 768,
              SSM state 128, in_proj (768, 3352)) through the launcher
              (the trained phase's command with W8 layers 0 and 23,
              ``--serve-smoke --serve``) under ``preempt_and_resume``
              (killed after block 10, resumed bit for bit), counters zeroed
              before and read after the uninterrupted run: K1 and K2 in
              both regimes and K3, every shape held against the plain
              versions as for whisper; the error sum must fall and
              ``--serve`` print its skip line (``unsupported_family:ssm``).
              On the export: 256 prefilled tokens (one SSD chunk) and 16
              decode steps against the chunked forward over 512, with the
              kernels and with the plain versions (logits within
              MAMBA_SCAN_TOL relative L2, greedy tokens equal but at
              near-ties), and each of the two with the kernels against the
              plain versions (5e-2); serve-smoke's prompt re-run plain; the
              int8 cache refused (``kv_quant_unsupported:ssm``); 8 decode
              steps traced. The kernels phase adds K1 and K2 at whisper's
              decoder sites (M 4 and the export's 1024; (1024, 4096) also
              at M 64) and K3 at M 1024; K1 and K2 at in_proj (M 2 and 64:
              N % 16 = 8, scalar code loads), K3 there at M 512; K1 and K3
              at both mamba2 sites at the export's 4096 rows, K1 and K2 at
              out_proj (M 2).
10. Hybrid  — recurrentgemma-2b at full width with 9 of its 26 layers
              (three whole RRA groups: 6 RG-LRU and 3 local-attention
              blocks, d_model = lru_width 2560, 10 heads and 1 KV head of
              256, geglu d_ff 7680, vocab 256000, window 2048), weights from
              torch.Generator seed 0: blocks 1 (R) and 2 (A) of the
              launcher's recipe graphed against graphs=False (bit for bit,
              two engines); then, counters zeroed before and read after,
              the launcher in process with the trained phase's command (W8
              layers 0 and 7, R blocks as 0 and 25 are at full depth) and
              ``--serve-smoke --serve``: three
              engines, the error sum must fall, the skip line
              (``unsupported_family:hybrid``), K1 in both regimes and K3
              (the W8 layers serve as W8A8: the hybrid's sites carry their
              layer index, so its activation states apply), every shape
              held against the plain versions (``check_path_shapes``).
              On the export: a greedy decode (batch 2, 2040 prefilled
              tokens, 16 steps: the ring of 2048 slots wraps) against the
              teacher-forced full forward (``forward_vs_decode``) and
              re-run along its tokens with the plain versions: bf16
              without the activation states within RG_DECODE_TOL and 5e-2,
              as exported (W4A8) within RG_A8_TOL (flipped A8 codes); in
              float32 on the fp weights within 1e-3; the
              int8 cache refused; 8 decode steps traced. The kernels phase
              adds K1/K2/K3 at its four sites (M 2) and K1/K3 at the
              export's 4096 rows.
11. Training — ``launch.steps.make_train_step`` with remat on: smollm-135m
              at full size (8 x 1024 tokens, 10 steps) and recurrentgemma-2b
              at full width with 3 layers (4 x 2048, 5 steps): loss, gnorm,
              ms per step (CUDA events), max_memory_allocated, finite
              losses and norms; the reduced float32 configs' 3 steps on
              the card
              against the CPU's, and microbatch 2 against 1; the training
              launcher (``--arch recurrentgemma-2b --smoke --steps 20
              --ckpt-every 10``) SIGKILLed after its step-10 checkpoint and
              resumed equals an unbroken run bit for bit.
12. Loss    — ``model.loss`` (the chunked cross entropy, each chunk
              recomputed in the backward) against an unchunked float32
              ``cross_entropy`` over the same hidden states, in float32 at
              full width: olmo-1b with 2 layers, B = 2, S = 1000 (two chunks
              of 512, the second padded) and phi-3-vision-4.2b with 2 of its
              32 layers and 256 random patch embeddings before 256 tokens.
              The loss (relative 1e-5) and the gradients of the embedding,
              the head and two of layer 1's weights (1e-4 of the largest)
              must agree, and the chunked run must peak below the other in
              max_memory_allocated.
13. Mesh    — data-parallel calibration (run after the auto-bits phase).
              (a) An NCCL group of one rank in process: smollm-135m at full
              width, ``MESH_LAYERS`` = 3 of its 30 layers (W8 layers 0 and
              2; all 30 until the cells phase took the seconds, 6 until
              the dry-run phase did), through
              ``quantize_blocks`` with the
              launcher's recipe at ``MESH_ITERS`` = 12 iterations, graphed,
              under ``make_flat_mesh(1)`` and without a mesh: finalized
              blocks, activation states, errors and curves equal bit for
              bit, 2 engines and 2 captures each; the collectives the
              captured steps issued (the minibatch's assembly and the
              gradients', 2 a step) are counted, and 20 replays of block
              1's step are traced; ``compressed_psum`` on the card equals
              dequant(quant(g)). (b) The debug mesh's 8 ranks on the one
              card (gloo: NCCL refuses two ranks on one device, so the
              engines run eagerly) through ``python -m
              torch.distributed.run --nproc-per-node 8 chip_smoke.py
              --mesh-child DIR <launcher flags>``, each rank calling
              ``repro_torch.launch.quantize.main`` with the smollm recipe,
              ``--mesh debug --iters 12 --serve-smoke --serve`` at
              ``MESH_LAYERS`` layers; rank 0
              counts its launches (the main path of this phase) and records
              its K1/K2/K3 shapes; every rank records its seconds, peak
              memory and the collectives' share of its Adam loop. Held
              against the single-process launcher at the same flags on the
              same calibration set: block 0's first loss within
              ``MESH_FIRST_TOL``, every block's error within a
              factor ``MESH_FACTOR``, their sum within ``MESH_SUM_TOL``,
              every site's layout and zero points equal (its codes follow
              chaotic states: PERF.md §6); every K1/K2/K3 shape
              the ranks gave that no earlier row held is held against its
              plain version. (c) ``--mesh production`` in one process exits
              non-zero naming the 256 ranks it needs. (d) A MoE block whose
              minibatch is one token group, split over 2 gloo ranks on the
              card (``chip_smoke.py --moe-mesh-child DIR`` under torchrun;
              tests/test_torch_moe_mesh.py's case: reduced llama4-scout,
              capacity factor 1.25, moe_group 64): the gathered teacher,
              the first loss, err_before, the 3-step curves and states of a
              full batch and of minibatches against one process
              (``MOE_MESH_*``).

14. Cells   — the cell programs (``launch.steps.build_cell`` on a mesh of
              one rank, ``launch.mesh.AbstractMesh((1, 1), ...)``), each
              at its shape's sequence length and the global batch over
              16 (the 16 x 16 layout's data axis), arguments drawn from
              the programs' ``meta`` stand-ins (``specs.materialize``,
              torch.Generator seed 0; quantized weights as random codes,
              scales and zeros; decode caches drawn whole):
              smollm-135m at full size ``train_4k`` (16 x 4096, 1 warm +
              1 timed step; 3 until the dry-run phase took the seconds), ``prefill_32k`` int8 (2 x 32768: K2 at M =
              65,536; its plain run first, then 1 timed) and ``decode_32k`` (8 x 32768, 1 warm + 10 timed
              steps at the cache's last positions) with bf16, int8 and
              int4 weights over a bf16 cache and int4 over an int8 one,
              and mamba2-130m ``long_500k`` int8 (1 x 524288, 10 timed
              steps). Counters zeroed before the first cell and read
              after the last. Each cell prints its median ms (CUDA
              events), ``roofline.analysis.analyze``'s compute and memory
              seconds, bottleneck and bound on the card's row, the bound
              over the measured time, MFU (model flops over measured time
              x bf16 peak), ``max_memory_allocated`` and its K1/K2
              launches. Each serve cell runs once more with the plain
              versions along the same inputs: its caches within 5e-2
              relative L2 and its next tokens equal but where the plain
              run's top-2 logit gap is within 5e-2 of its largest logit
              (counted); then 1 + CELL_TRACED_STEPS = 2 more kernel steps
              of each smollm decode cell, the 2 traced with obs.profiler
              (device-busy share, device ops a step, host syncs, top 5).
              Every K1/K2 shape the cells gave is held against the plain
              version (``check_path_shapes``).

15. Dry run — ROADMAP item 14.2 on the card's machine. (a) The production
              cells ``DRY_CELLS`` (smollm-135m at full size: ``train_4k``,
              ``prefill_32k`` int8 and ``decode_32k`` int8 on 16 x 16 and
              2 x 16 x 16; llama4-scout-17b-a16e at full size
              ``train_4k`` on 16 x 16: fsdp, the MoE's hints) traced by
              ``launch.dryrun.run_cell`` on fake process groups of 256 and
              512 ranks, in child processes on the host
              (``chip_smoke.py --dryrun-child OUT CELL...``, three, one
              thread each, at the lowest priority, stopped while the
              mesh phase's 8 ranks run) started after the kernels phase
              and read at the end:
              each cell prints its trace seconds, peak GiB per device,
              collective bytes by kind, the three roofline terms on the
              card's row and the bottleneck, then ``roofline.report``'s
              summary and table. (b) The traced programs on 2 ranks of
              the card (``chip_smoke.py --sharded-child DIR`` under
              torchrun; gloo, NCCL refusing two ranks on one device),
              ``SHARDED_RUNS`` at ``SHARDED_LAYERS`` = 4 layers and full
              width: smollm-135m's ``decode_32k`` int8 (the cells phase's
              8 x 32768) on (1, 2), its ``train_4k`` (16 x 4096, dp,
              float32) on (2, 1), olmo-1b's ``train_4k`` (4 x 4096, tp,
              float32) on (1, 2). Each is traced beside part (a) (a fake
              group of 2, ``--sharded-trace-child``); a cell whose trace
              holds a collective gloo cannot carry on CUDA tensors (any
              but all-reduce: ``GLOO_CUDA``) is named and runs at world 1
              only, and at least one dp and one tp cell must run on the
              2 ranks. Every cell runs as the plain cell program and on
              an NCCL world of one (a (1, 1) CUDA mesh: K2 on its shard,
              the main path of this phase) in process: decode tokens
              equal but for the plain run's near-ties, each cache entry
              within ``SHARDED_CACHE_ATOL`` + ``SHARDED_CACHE_RTOL`` of the
              largest magnitude; the 2-rank train cells' loss and
              gradient norm within ``SHARDED_LOSS_TOL`` of the world of
              one's, and its of the plain program's; on each rank the
              collectives ``CommDebugMode`` counts equal, kind by kind,
              the trace's. The world of one's decode kernel shapes and
              rank 0's of the 2-rank runs are held against their plain
              versions. Then ``_on_shards``' rules on the card
              (``shard_rule_check``): each K2 shape of that decode with
              its weight split on N and on K over a (1, 2) CUDA mesh of
              a fake group, as rank 0 and as rank 1, the local product
              against the plain version on the rank's halves.

Every phase logs its seconds. The line before the last is the JSON kernel
summary (K1-K5, launches per path); the last line
is ``{"ok": true, "device": {...}}``. A per-shape table goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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

# the card's published peaks (bytes/s, ops/s by input type): its row of
# repro_torch.roofline.analysis.CARD_PEAKS, set by main()
PEAKS = None
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
# qwen2.5-14b's MLP sites: w_up/w_gate (5120, 13824) and w_down (13824,
# 5120), a 13824-deep contraction (6912 packed code rows)
QWEN_2D = ((5120, 13824), (13824, 5120))
QWEN_LAYERS = 4  # of 48: 5.3 GB of bf16 weights, 1.56 GB of them the
                 # untied embedding and head
OLMO_LAST = 15   # olmo-1b's last layer, W8 in its launcher run
OLMO_ITERS = 50  # TRAIN_ITERS until the dry-run phase took the seconds
# deepseek-v3-671b: 4 of 61 layers (the 3 leading dense layers and 1 MoE
# layer: 30.2 GB of bf16 weights); its 2-D sites (MLA's wq_a, wq_b, wkv_a,
# wkv_b, wo; the dense MLP; the shared expert) and expert stacks
DEEPSEEK_LAYERS = 4
DEEPSEEK_2D = ((7168, 1536), (1536, 24576), (7168, 576), (512, 32768),
               (16384, 7168), (7168, 18432), (18432, 7168), (7168, 2048),
               (2048, 7168))
DEEPSEEK_EXPERTS = ((7168, 2048), (2048, 7168))
DEEPSEEK_E = 256
# block 0's graphed-vs-eager reconstruction at the launcher's lr 3e-3: the
# first Adam step moves each s1 by ~lr, about half of a 4-bit grid step of
# these weights, and raises the error ~7x; on an H100 20 steps still end
# above the start (0.067 -> 0.132), 100 end at a third of it (0.021)
DEEPSEEK_RECON_ITERS = 100
DEEPSEEK_SMOKE_ITERS = 100  # the reduced config through the launcher
# whisper-medium's decoder sites: the eight (1024, 1024) projections of
# self- and cross-attention, w_up and w_down
WHISPER_2D = ((1024, 1024), (1024, 4096), (4096, 1024))
WHISPER_CALIB = 16  # calibration samples = the minibatch: the encoder output
                    # baked into every decoder block holds all of them
WHISPER_EXPORT_M = WHISPER_CALIB * 64  # rows of the export's decoder sites
WHISPER_BLOCK0_ITERS = 20  # block 0, graphed against graphs=False
# all 24 decoder blocks; 100 until the cells phase needed the seconds, 60
# until the dry-run phase did (on an H100 at 100 the error sum fell 2.396
# -> 1.203, each W4 block's to under half by then)
WHISPER_ITERS = 40
WHISPER_SERVE = (4, 16, 16)  # batch, prompt tokens, greedy steps
# mamba2-130m: in_proj (768, 3352), whose N % 16 = 8 sends K1/K2/K3 down
# their scalar code loads with a last N tile of 24 columns; out_proj
# (1536, 768)
MAMBA_IN = (768, 3352)
MAMBA_OUT = (1536, 768)
MAMBA_LAST = 23     # mamba2's last layer, W8 in its launcher run
MAMBA_EXPORT_M = 64 * 64  # the launcher's calibration set, 64 x 64 tokens
MAMBA_PREEMPT_AT = 10
MAMBA_PREFILL = 256  # one SSD chunk
MAMBA_DECODE = 16
# scan against decode in bf16 on the export, with the kernels and with the
# plain versions: the limit both readings are held to. On an H100 they read
# 4.43e-2 and 4.41e-2 (the model's bf16 rounding: the chunked path rounds
# the conv's products to bf16, the recurrence sums them in float32), and
# in float32 2.2e-5; a wrong scan, decode or kernel is off by O(1)
MAMBA_SCAN_TOL = 8e-2
# recurrentgemma-2b (26 layers RRA, d_model = lru_width 2560, 10 heads and
# 1 KV head of 256, geglu d_ff 7680, vocab 256000, window 2048): its four
# site shapes ((2560, 256): wk/wv, the narrowest N of any path; w_down
# 7680 deep), the W8 last layer, the export's rows (64 x 64 tokens)
RG_2D = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
# the launcher runs 9 of the 26 layers: three whole (R, R, A) groups; every
# kernel shape is the full depth's (shapes do not depend on depth). The W8
# last layer is the cut's last R block, as layer 25 is at full depth: the
# same three engines (R at W8, R at W4, A at W4) and K3 shapes
RG_LAYERS = 9
RG_LAST = 7
RG_EXPORT_M = 64 * 64
RG_GRAPH_ITERS = 20  # blocks 1 (R) and 2 (A), graphed against graphs=False
# the greedy decode over the export: batch 2, a 2040-token prefill and 16
# steps, so the ring of 2048 slots wraps after 8; its logits against the
# teacher-forced full forward: in float32 on the fp weights within 1e-3;
# in bf16 on the export served without its activation states (W4A16, W8A16)
# within RG_DECODE_TOL, the bound mamba2's bf16 scan against its decode is
# held to (the recurrence and the full forward round in other places; on
# an H100 4.42e-2), and re-run along its tokens with the plain versions
# within 5e-2, as every plain re-run. Served as exported (W4A8, W8A8) each
# bf16 rounding difference that moves an activation across a rounding
# boundary of its per-tensor 8-bit grid flips a code, and the layers
# amplify that: on an H100 at full depth (26 layers) the decode read 0.324
# against the forward and 0.179 against the plain versions. Those two are held to RG_A8_TOL, under
# half of the sqrt(2) that unrelated logits read: a wrong scan, ring or
# kernel is off by O(1); the kernels themselves are held at every shape
# the path gives them (check_path_shapes)
RG_PROMPT = 2040
RG_DECODE = 16
RG_DECODE_TOL = 8e-2
RG_A8_TOL = 0.6
# training: (arch, layers (None: all), batch, sequence, steps), each with
# cfg.remat on; the reduced float32 configs held card against CPU; the
# launcher's kill after its step-10 checkpoint and the resume to step 20
TRAIN_RUNS = (("smollm-135m", None, 8, 1024, 10),
              ("recurrentgemma-2b", 3, 4, 2048, 5))
TRAIN_CHECK_ARCHS = ("smollm-135m", "recurrentgemma-2b")
TRAIN_KILL_AT = 10
TRAIN_STEPS = 20
# the loss phase: (arch, layers, batch, text tokens, patch embeddings)
LOSS_RUNS = (("olmo-1b", 2, 2, 1000, 0), ("phi-3-vision-4.2b", 2, 2, 256, 256))
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
AUTO_ITERS = 50  # TRAIN_ITERS until the dry-run phase took the seconds
AUTO_BITS_OTHER = "4.0"
# checkpoints and exports of the launcher phases (under build/, gitignored)
RUNS_DIR = ROOT / "build" / "chip_smoke_runs"
# the trained phase's launcher telemetry (``--telemetry``), validated after
# the run by the port's sink CLI
TELEMETRY_DIR = ROOT / "build" / "chip_smoke_telemetry"
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
    t_bytes = byte_count / PEAKS.hbm_bytes_per_s
    t_ops = n_ops / PEAKS.ops[in_type]
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
    from repro_torch.analysis.diffcheck import matmul_tol
    tol = matmul_tol(x, w, want, K)
    del w
    if not bool((err <= tol).all()):
        fail(f"{name} {M}x{K}x{N} {dtype}: max |err| {err.max().item():.3e} "
             f"beyond the stated tolerance")
    row = {"kernel": name, "M": M, "K": K, "N": N,
           "x": str(dtype).replace("torch.", ""), "regime": p.regime,
           "tile": p.kernel, "splits": p.splits, "misaligned": misalign,
           "vec_codes": p.vec_codes, "max_abs_err": err.max().item()}
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
    from repro_torch.analysis.diffcheck import int8_epilogue_tol
    tol = int8_epilogue_tol(a_q, b_q, exact, a_scale, a_zero, b_scale, b_zero)
    err = (got.double() - want.double()).abs()
    if got.shape != (M, N) or not bool((err <= tol).all()):
        fail(f"{tag}: max |err| {err.max().item():.3e} beyond the epilogue "
             "rounding bound")
    row = {"kernel": "qmatmul_int8", "M": M, "K": K, "N": N, "x": "int8",
           "codes": codes, "misaligned": misalign, "splits": p.splits,
           "vec_b": p.vec_b, "max_abs_err": err.max().item()}
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


# K5's rows of x: "dense" (every row non-zero); as a decode step's dispatch
# builds them from 4 tokens routed top-1 to 4, 2 or 1 experts ("routed4",
# "routed2", "routed1"), or from deepseek-v3's 2 tokens routed top-8 to 16
# distinct of its 256 experts ("top8x2"), the other experts' rows zero;
# "partial" (expert 1 zero over the first half of K only, expert 2 all
# zero, the rest dense); "zero" (every row zero, half of the experts -0)
K5_ROUTED = {"routed4": (1, 6, 9, 14), "routed2": (3, 3, 12, 12),
             "routed1": (5, 5, 5, 5),
             "top8x2": (tuple(range(3, 256, 32)), tuple(range(19, 256, 32)))}


def _k5_x(torch, E, M, K, dtype, pattern, gen):
    if pattern in K5_ROUTED:
        # the dispatch einsum of models/moe.py: token t to slot c of expert e
        experts = K5_ROUTED[pattern]
        tokens = torch.randn((len(experts), K), generator=gen,
                             device=DEV).to(dtype)
        dispatch = torch.zeros((len(experts), E, M), device=DEV, dtype=dtype)
        filled = {}
        for t, es in enumerate(experts):
            for e in (es if isinstance(es, tuple) else (es,)):
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
    from repro_torch.analysis.diffcheck import matmul_tol
    tol = matmul_tol(x, w, want, K)
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
    # qwen2.5-14b's MLP sites: decode and export through both planners
    for M in (4, 512):
        for K, N in QWEN_2D:
            for dtype in (torch.bfloat16, torch.float32):
                for name in ("dequant_matmul_w4", "dequant_matmul_w8"):
                    rows.append(check_dequant(torch, k12, ref, name, M, K, N,
                                              dtype, gen,
                                              dtype == torch.bfloat16))
    for K, N in QWEN_2D:
        rows.append(check_int8(torch, k3, ref, 512, K, N, gen, timed=True))
    # deepseek-v3's 2-D sites (MLA, the 18432-wide dense MLP, the shared
    # expert): decode at batch 2, the 2 x 16 prefill and the export's 512
    # tokens; K3 (the W8A8 layer 0) at the export
    for M in (2, 32, 512):
        for K, N in DEEPSEEK_2D:
            for name in k12_names:
                rows.append(check_dequant(
                    torch, k12, ref, name, M, K, N, torch.bfloat16, gen,
                    name == "dequant_matmul_w4" or M == 2))
    for K, N in DEEPSEEK_2D:
        rows.append(check_int8(torch, k3, ref, 512, K, N, gen, timed=True))
    # whisper-medium's decoder sites: K1 and K2 at the serving batch of 4,
    # K1 at the prefill's 4 x 16 rows, K1 (mma) and K3 at the export's
    # 16 x 64 (the path's other shapes: check_path_shapes)
    for K, N in WHISPER_2D:
        for name in k12_names:
            for M in (4, WHISPER_EXPORT_M):
                rows.append(check_dequant(torch, k12, ref, name, M, K, N,
                                          torch.bfloat16, gen, True))
        rows.append(check_int8(torch, k3, ref, WHISPER_EXPORT_M, K, N, gen,
                               timed=True))
    rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w4", 64, 1024,
                              4096, torch.bfloat16, gen, True))
    # mamba2-130m: in_proj's misaligned N (scalar code loads, a last tile of
    # 24 columns) at serve-smoke's batch 2 and at 64 rows, K3 at 512 rows;
    # both sites at the export's 64 x 64 rows (K1 mma and K3) and at decode
    # (K1 and K2)
    n_rows = len(rows)
    for M in (2, 64):
        for name in k12_names:
            rows.append(check_dequant(torch, k12, ref, name, M, *MAMBA_IN,
                                      torch.bfloat16, gen, True))
    rows.append(check_int8(torch, k3, ref, 512, *MAMBA_IN, gen, timed=True))
    for K, N in (MAMBA_IN, MAMBA_OUT):
        rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w4",
                                  MAMBA_EXPORT_M, K, N, torch.bfloat16, gen,
                                  True))
        rows.append(check_int8(torch, k3, ref, MAMBA_EXPORT_M, K, N, gen,
                               timed=True))
    for name in k12_names:
        rows.append(check_dequant(torch, k12, ref, name, 2, *MAMBA_OUT,
                                  torch.bfloat16, gen, True))
    if any(r.get("vec_codes") or r.get("vec_b") for r in rows[n_rows:]
           if r["N"] == MAMBA_IN[1]):
        fail(f"mamba2 in_proj (N = {MAMBA_IN[1]}) planned 16-byte loads")
    # recurrentgemma-2b's sites at its decode batch of 2: K1 (the W4A8
    # body) and K3 (the W8A8 layers 0 and 25; w_down's 7680-deep
    # contraction splits K in 3), with K2 beside K1; K1 and K3 at the
    # export's 64 x 64 rows (the path's other shapes: check_path_shapes)
    for K, N in RG_2D:
        for name in k12_names:
            rows.append(check_dequant(torch, k12, ref, name, 2, K, N,
                                      torch.bfloat16, gen, True))
        rows.append(check_int8(torch, k3, ref, 2, K, N, gen, timed=True))
        rows.append(check_dequant(torch, k12, ref, "dequant_matmul_w4",
                                  RG_EXPORT_M, K, N, torch.bfloat16, gen,
                                  True))
        rows.append(check_int8(torch, k3, ref, RG_EXPORT_M, K, N, gen,
                               timed=True))
    torch.cuda.empty_cache()
    # K5 at the expert stacks: decode / prefill (C = 4) and export (C = 40)
    for M in (4, 40):
        for K, N in LLAMA4_EXPERTS:
            for packed in (True, False):
                for dtype in (torch.bfloat16, torch.float32):
                    rows.append(check_batched(torch, k12, ref, LLAMA4_E, M, K,
                                              N, packed, dtype, gen,
                                              dtype == torch.bfloat16))
            torch.cuda.empty_cache()
    # deepseek-v3's 256 packed expert stacks: a decode step's x (2 tokens
    # top-8: 16 experts hold a row) and the export's (4 groups x capacity 8
    # rows of every expert)
    for K, N in DEEPSEEK_EXPERTS:
        for M, pattern in ((4, "top8x2"), (32, "dense")):
            rows.append(check_batched(torch, k12, ref, DEEPSEEK_E, M, K, N,
                                      True, torch.bfloat16, gen, True,
                                      pattern))
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


# ---------------------------------------------------------------- analysis
# the full-width sites the QL304 policy is also held at (the smollm path's
# K1/K2/K3 shapes and llama4-scout's K5 at a decode step); w4_odd_unpacked
# is an odd-K layout and no site of the paths has an odd K
ANALYSIS_SITES = ("wq", "wo", "w_up", "w_down")
ANALYSIS_M = (4, 512)
ANALYSIS_2D_LAYOUTS = ("w4_packed", "w4a8_packed", "w8a8", "w8_weight_only")
ANALYSIS_EXPERTS = (LLAMA4_E, 4, 5120, 8192)  # E, M, K, N
# regimes the lattice must reach per dtype: bf16 x takes K1/K2/K5's decode
# (M <= 8) and mma tiles, float32 x their fp32 kernel
ANALYSIS_REGIMES = {"bfloat16": ("decode", "mma"), "float32": ("fp32",)}


def analysis_phase(torch):
    """The static checks on the card: the full report (AST rules, the
    traced-graph layers with memcheck, the kernel coverage and the full
    QL304 lattice in float32 and bfloat16,
    ``repro_torch.analysis.lint.run_analysis``), the same parity check at
    the full-width shapes the paths give the kernels, then the graph
    layers' own card checks (``analysis_graph_checks``). Returns the
    phase's numbers."""
    import tempfile

    from repro_torch.analysis import diffcheck as dc
    from repro_torch.analysis.lint import run_analysis

    t0 = time.perf_counter()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        pj, cj = Path(tmp, "parity.json"), Path(tmp, "coverage.json")
        mj = Path(tmp, "mem.json")
        rep = run_analysis(mem=True, mem_json=str(mj), decode_smoke=True,
                           diff_full=True, device=DEV, parity_json=str(pj),
                           coverage_json=str(cj), log=lines.append)
        parity = json.loads(pj.read_text())
        coverage = json.loads(cj.read_text())
        records = json.loads(mj.read_text())["entries"]
    lattice_s = time.perf_counter() - t0
    if rep.exit_code() or rep.errors():
        fail("analysis: " + "; ".join(f"{f.rule}/{f.name} {f.where}: "
                                      f"{f.message}" for f in rep.errors()[:6]))
    report = report_summary(rep, records)
    rows = parity["rows"]
    log(f"analysis: quantlint {len(rep.errors())} errors, "
        f"{len(rep.warnings())} warnings (QL207 conv fallbacks: "
        f"{sorted(f.where for f in rep.warnings())}); QL304 full lattice "
        f"{parity['n_rows']} cells, n_fail {parity['n_fail']}")
    if parity["n_fail"] or parity["n_rows"] < 20 * 6 * 2:
        fail(f"analysis: QL304 {parity['n_fail']} of {parity['n_rows']} "
             "cells failed (or too few cells)")
    per = {}
    for r in rows:
        if (r["kernel_plain"], r["kernel"]) != dc.EXPECTED_KERNELS[r["layout"]]:
            fail(f"analysis: {r['layout']} {r['shape']} {r['dtype']} "
                 f"dispatched to ({r['kernel_plain']}, {r['kernel']})")
        d = per.setdefault((r["layout"], r["dtype"]), {
            "kernel": r["kernel"], "regimes": set(), "cells": 0, "ratio": -1})
        d["regimes"].update(r["regimes"])
        d["cells"] += 1
        if r["ratio"] > d["ratio"]:
            d.update(ratio=r["ratio"], err=r["max_abs_err"], bound=r["bound"],
                     shape=r["shape"])
    for (layout, dtype), d in sorted(per.items()):
        log(f"  {layout:16s} {dtype:8s} {d['cells']:3d} cells {d['kernel']}"
            f"[{','.join(sorted(d['regimes']))}] worst |err| {d['err']:.3e} "
            f"against its bound {d['bound']:.3e} ({d['ratio']:.3f}) at "
            f"{tuple(d['shape'])}")
        if layout != "w8a8":
            missing = set(ANALYSIS_REGIMES[dtype]) - d["regimes"]
            if missing:
                fail(f"analysis: {layout} {dtype} never took {sorted(missing)}")
    for r in coverage["rows"]:
        log(f"  coverage {r['site']} {tuple(r['shape'])} w{r['bits']}: "
            f"{r['kernel']} {','.join(r['regimes'])}")

    # the paths' full-width shapes, through the same policy
    full = []
    cells = list(dict.fromkeys(
        (layout, 1, m, *SMOLLM_SITES[site]) for layout in ANALYSIS_2D_LAYOUTS
        for site in ANALYSIS_SITES for m in ANALYSIS_M))
    cells.append(("experts_batched", *ANALYSIS_EXPERTS))
    for layout, e, m, k, n in cells:
        row = dc.check_parity(layout, e, m, k, n, dtype=torch.bfloat16)
        if not row.ok or (row.kernel_plain, row.kernel) != \
                dc.EXPECTED_KERNELS[layout]:
            fail(f"analysis: full width {layout} (e, m, k, n) = "
                 f"{(e, m, k, n)}: {row}")
        full.append(row.to_json())
        log(f"  full width {layout:16s} {(e, m, k, n)} bf16 "
            f"{row.kernel}[{','.join(row.regimes)}] |err| "
            f"{row.max_abs_err:.3e} bound {row.bound:.3e} ({row.ratio:.3f})")
    gc.collect()
    torch.cuda.empty_cache()
    full_s = time.perf_counter() - t0 - lattice_s
    graph = analysis_graph_checks(torch)
    seconds = time.perf_counter() - t0
    log(f"analysis: full report {lattice_s:.1f}s, full width {full_s:.1f}s "
        f"({len(full)} cells), graph checks {graph['seconds']:.1f}s")
    return {"n_rows": parity["n_rows"], "n_fail": parity["n_fail"],
            "seconds": seconds, "lattice_seconds": lattice_s,
            "report": report, "graph": graph,
            "per_layout": [{"layout": k[0], "dtype": k[1],
                            "kernel": d["kernel"],
                            "regimes": sorted(d["regimes"]),
                            "cells": d["cells"], "worst_ratio": d["ratio"],
                            "worst_err": d["err"], "worst_bound": d["bound"],
                            "worst_shape": d["shape"]}
                           for k, d in sorted(per.items())],
            "coverage": coverage["rows"], "full_width": full,
            "parity_rows": rows,
            "warnings": [f.where for f in rep.warnings()]}


SEEDED_BUGS = (("a_state_drop", "QL201"), ("per_layer_retrace", "QL202"),
               ("int8_overflow", "QL301"), ("scale_underflow", "QL303"),
               ("lost_psum", "QL305"), ("dead_donation", "QL402"),
               ("hbm_blowout", "QL401"))
ANALYSIS_MESH_RANKS = 2


def report_summary(rep, records):
    """The full report's QL301 proof and QL401 peaks, logged."""
    proofs = [f.message for f in rep if f.rule == "QL301"
              and f.severity == "info" and f.message.startswith("proven")]
    for p in proofs:
        log(f"analysis: QL301 {p}")
    if not any("qtensor_matmul[w8a8]" in f.where for f in rep
               if f.rule == "QL301" and f.severity == "info"):
        fail("analysis: no QL301 proof of the W8A8 accumulator")
    peaks = []
    for r in records:
        if "budget_trace_bytes" not in r:
            continue
        row = {k: r.get(k) for k in (
            "entry", "max_len", "peak_trace_bytes", "budget_trace_bytes",
            "envelope_len", "peak_envelope_bytes", "budget_envelope_bytes",
            "peak_above_inputs_bytes", "peak_rounded_bytes")}
        peaks.append(row)
        env = ("" if not r.get("envelope_len") else
               f", at L={r['envelope_len']} {r['peak_envelope_bytes']} B of "
               f"{r['budget_envelope_bytes']} B")
        log(f"analysis: QL401 {r['entry']}: peak {r['peak_trace_bytes']} B "
            f"of {r['budget_trace_bytes']} B at L={r['max_len']}{env}")
    return {"errors": len(rep.errors()), "warnings": len(rep.warnings()),
            "findings": len(rep.findings), "ql301_proofs": proofs,
            "ql401": peaks}


def seeded_runs(torch):
    """The seven seeded bugs through ``run_analysis``, in process: each
    must fail with an error of its rule."""
    from repro_torch.analysis.lint import run_analysis
    out = []
    for bug, rule in SEEDED_BUGS:
        t0 = time.perf_counter()
        rep = run_analysis(jaxpr_only=True, mem=True, seed_bug=bug,
                           device=DEV, log=lambda *a, **k: None)
        hit = [f for f in rep.errors() if f.rule == rule]
        dt = time.perf_counter() - t0
        if rep.exit_code() != 1 or not hit:
            fail(f"analysis: seeded {bug} raised no {rule} error: "
                 f"{[(f.rule, f.where) for f in rep.errors()]}")
        if bug == "per_layer_retrace" and "captures grew by" not in \
                hit[0].message:
            fail(f"analysis: the per-layer retrace captured nothing on the "
                 f"card: {hit[0].message}")
        log(f"analysis: seeded {bug}: {rule} {hit[0].where} ({dt:.1f}s): "
            f"{hit[0].message[:160]}")
        out.append({"bug": bug, "rule": rule, "where": hit[0].where,
                    "errors": sorted({f.rule for f in rep.errors()}),
                    "seconds": dt, "message": hit[0].message})
    return out


def _replays(torch, entries):
    """``memcheck.replay_peak`` of each entry, held to the static peak."""
    from repro_torch.analysis.memcheck import check_memory, replay_peak
    rows = []
    for e in entries:
        got = replay_peak(e)
        rec = check_memory(e)[1]
        m, st = got["measured_bytes"], got["static_rounded_bytes"]
        row = {"entry": e.name, "measured_bytes": m,
               "static_rounded_bytes": st,
               "static_bytes": rec["peak_above_inputs_bytes"],
               "ratio": m / st if st else None}
        rows.append(row)
        log(f"analysis: replay {e.name}: allocator peak {m} B above the "
            f"inputs, static {rec['peak_above_inputs_bytes']} B "
            f"({st} B in 512-B blocks), ratio "
            f"{'-' if not st else f'{m / st:.4f}'}")
        if not 0 <= m <= st:
            fail(f"analysis: {e.name}'s replay peaked at {m} B, above its "
                 f"static peak of {st} B in 512-byte blocks")
    return rows


def analysis_graph_checks(torch):
    """The graph layers' card checks (the analysis phase's docstring):
    seeded bugs, the graphed chain, replays, the sharded entry."""
    from repro_torch.analysis import graph_checks as gcheck
    from repro_torch.analysis import trace as tr
    from repro_torch.obs import compile_events

    t0 = time.perf_counter()
    seeded = seeded_runs(torch)
    seeded_s = time.perf_counter() - t0
    c0 = compile_events.captures()
    chain = gcheck.check_retrace(per_layer=False, device=DEV)
    c1 = compile_events.captures()
    if chain.errors():
        fail(f"analysis: the 2-to-4-block chain recaptured: "
             f"{chain.errors()[0].message}")
    log(f"analysis: graphed toy chain 2 -> 4 blocks: 0 new captures in the "
        f"4-block run ({c1 - c0} captures in the call, the 2-block warm-up's "
        f"included)")
    lm = tr.deploy_smoke_lm(device=DEV)
    entries = [tr.recon_chunk_entry(device=DEV),
               tr.probe_entry(device=DEV),
               tr.deploy_decode_entry(lm=lm, device=DEV),
               tr.serve_prefill_entry(lm=lm, device=DEV),
               tr.serve_decode_entry(lm=lm, device=DEV),
               tr.serve_decode_entry(kv_quant=False, lm=lm, device=DEV),
               tr.hbm_blowout_entry(DEV)]
    replays = _replays(torch, entries)
    del entries, lm
    gc.collect()
    t1 = time.perf_counter()
    sharded = analysis_mesh_check(torch)
    sharded_s = time.perf_counter() - t1
    return {"seconds": time.perf_counter() - t0, "seeded": seeded,
            "seeded_s": seeded_s, "chain_captures_in_call": c1 - c0,
            "replays": replays, "sharded": sharded, "sharded_s": sharded_s}


def analysis_mesh_child(out_dir: str) -> int:
    """One rank of the sharded recon entry (under torchrun): traced on a
    flat (2, 1) mesh of gloo ranks sharing the card, checked, saved."""
    import os

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import graph_checks as gcheck
    from repro_torch.analysis import trace as tr
    from repro_torch.analysis.intervals import check_intervals
    from repro_torch.analysis.shardcheck import check_shard_safety
    from repro_torch.launch import mesh as meshes
    dev = meshes.init_distributed(torch.device(DEV))
    mesh = meshes.make_flat_mesh(ANALYSIS_MESH_RANKS, device_type=DEV)
    entry = tr.recon_chunk_entry(mesh=mesh, device=dev)
    rows = {"name": entry.name, "captured": entry.captured,
            "collectives": [[c.op, c.group_size, c.backend, c.data_group]
                            for c in entry.collectives]}
    for name, rep in (("graph", gcheck.check_entry(entry)),
                      ("intervals", check_intervals(entry)),
                      ("shard", check_shard_safety(entry))):
        rows[name] = [[f.rule, f.severity, f.where, f.message] for f in rep]
    Path(out_dir, f"rank{os.environ['RANK']}.json").write_text(
        json.dumps(rows))
    meshes.shutdown()
    return 0


def analysis_mesh_check(torch):
    """The sharded recon entry on ANALYSIS_MESH_RANKS gloo ranks of the
    card (torchrun): no error, QL206 and QL305 quiet, every collective
    over the data group."""
    import os
    d = RUNS_DIR / "analysis_mesh"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(ANALYSIS_MESH_RANKS), "--master-addr", "localhost",
           "--master-port", str(_free_port()), str(ROOT / "chip_smoke.py"),
           "--analysis-mesh-child", str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    with open(d / "torchrun.log", "w") as fh:
        proc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                              env=env, cwd=str(ROOT), timeout=300)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"analysis: the sharded entry's {ANALYSIS_MESH_RANKS}-rank run "
             f"exited {proc.returncode}:\n"
             f"{(d / 'torchrun.log').read_text()[-4000:]}")
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(ANALYSIS_MESH_RANKS)]
    for r, rows in enumerate(ranks):
        errs = [f for k in ("graph", "intervals", "shard") for f in rows[k]
                if f[1] == "error"]
        loud = [f for k in ("graph", "shard") for f in rows[k]
                if f[0] in ("QL206", "QL305")]
        colls = rows["collectives"]
        if errs or loud or not colls or not all(
                c[3] and c[1] == ANALYSIS_MESH_RANKS for c in colls):
            fail(f"analysis: sharded entry on rank {r}: errors {errs}, "
                 f"QL206/QL305 {loud}, collectives {colls}")
    log(f"analysis: {ranks[0]['name']} on {ANALYSIS_MESH_RANKS} gloo ranks "
        f"({ranks_s:.1f}s): {len(ranks[0]['collectives'])} collectives, "
        f"all over the data group ({ranks[0]['collectives'][0][2]}); QL206 "
        f"and QL305 quiet, 0 errors; captured {ranks[0]['captured']}")
    shutil.rmtree(d, ignore_errors=True)
    return {"seconds": ranks_s, "name": ranks[0]["name"],
            "collectives": ranks[0]["collectives"],
            "captured": ranks[0]["captured"],
            "findings": ranks[0]["graph"] + ranks[0]["shard"]}


def analysis_path_checks(torch, model, qparams, ctx, engine, requests,
                         outs):
    """On the smollm path (after its counters are read): a second wave of
    its requests through its graphed engine inside ``no_retrace(0)`` (0
    new captures, K1 and K2 launched), then the full-width deploy decode
    and serving bodies traced from the export: QL403 equal to
    tree_weight_bytes, QL405 to hbm_per_slot_bytes, the decode replayed
    against the allocator."""
    from repro_torch.analysis import no_retrace
    from repro_torch.analysis import trace as tr
    from repro_torch.analysis.memcheck import (check_kv_static_gap,
                                               check_memory)
    from repro_torch.core.qtensor import tree_weight_bytes
    from repro_torch.kernels import ops
    from repro_torch.obs import compile_events

    t0 = time.perf_counter()
    before, c0 = ops.launch_counts(), compile_events.captures()
    with no_retrace(0):
        outs2, _, _ = serve_all(engine, requests)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    wave = {k: after[k] - before[k] for k in after}
    captures = compile_events.captures() - c0
    same = outs2 == outs
    log(f"analysis: second serving wave under no_retrace(0): {captures} new "
        f"captures, launches K1 {wave['dequant_matmul_w4']}, K2 "
        f"{wave['dequant_matmul_w8']}, K3 {wave['qmatmul_int8']}; tokens "
        f"equal to the first wave's: {same}")
    if captures or wave["dequant_matmul_w4"] == 0 or \
            wave["dequant_matmul_w8"] == 0:
        fail(f"analysis: second wave: {captures} captures, launches {wave}")
    lm = (model.cfg, model, qparams, ctx)
    entries = [tr.deploy_decode_entry(lm=lm, device=DEV),
               tr.serve_decode_entry(lm=lm, device=DEV),
               tr.serve_decode_entry(kv_quant=False, lm=lm, device=DEV)]
    wbytes = tree_weight_bytes(qparams)
    recs, per_slot = [], {}
    for e in entries:
        rep, rec = check_memory(e)
        recs.append(rec)
        exp = {r["measure"]: r for r in rec["expect"]}
        per_slot[e.name] = exp["kv_cache"]["expected_bytes"] // e.mem.slots
        if rep.errors() or exp["weights"]["static_bytes"] != wbytes or \
                exp["weights"]["expected_bytes"] != wbytes or \
                exp["kv_cache"]["static_bytes"] != \
                exp["kv_cache"]["expected_bytes"]:
            fail(f"analysis: full-width {e.name}: {rep.errors()[:2]}, "
                 f"expect {rec['expect']}, tree_weight_bytes {wbytes}")
        log(f"analysis: full-width {e.name}: QL403 weights "
            f"{exp['weights']['static_bytes']} B = tree_weight_bytes "
            f"{wbytes} B; KV {exp['kv_cache']['static_bytes']} B; static "
            f"peak {rec['peak_trace_bytes']} B")
    gap = check_kv_static_gap(entries[1:])
    del per_slot[entries[0].name]  # the uniform decode's cache has no slots
    if gap.errors() or not gap.by_rule("QL405"):
        fail(f"analysis: full-width QL405: {[f.message for f in gap]}")
    log(f"analysis: full-width QL405: {gap.by_rule('QL405')[0].message}; "
        f"hbm_per_slot_bytes {per_slot}")
    replays = _replays(torch, entries[:1])
    del entries
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0,
            "second_wave": {"captures": captures, "launches": wave,
                            "tokens_equal": same},
            "full_width": [{k: r.get(k) for k in (
                "entry", "expect", "peak_trace_bytes",
                "peak_above_inputs_bytes", "window_state_bytes_per_token")}
                for r in recs],
            "tree_weight_bytes": wbytes, "hbm_per_slot_bytes": per_slot,
            "ql405": gap.by_rule("QL405")[0].message, "replays": replays}


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
    time in it; ``host_syncs`` the runtime's synchronize calls and
    ``copies_to_device`` the host-to-device copies that start in it;
    ``nccl_ops`` the device ops NCCL launched in it."""
    files = sorted(trace_dir.glob("*.json"))
    events = json.loads(files[-1].read_text())["traceEvents"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == mark]
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    spans, by_name, syncs, h2d, nccl = [], {}, 0, 0, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        if lo <= e["ts"] < hi:
            if e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"]:
                syncs += 1
            elif e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
                h2d += 1
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            spans.append((a, b))
            nccl += "nccl" in e["name"].lower()
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
            "device_ops": len(spans), "nccl_ops": nccl, "host_syncs": syncs,
            "copies_to_device": h2d,
            "top5": [{"name": n[:120], "ms": t / 1e3} for n, t in top]}


def serve_phase(torch, np, model, qparams, ctx, export_counts, tag,
                keep=None):
    """The main path's serving run (graphed) with the counters running,
    then, after the main path's counters are read, the eager comparison
    and the two profiled decode windows. Returns (counts at the end of the
    main path, requests, outputs, stats); ``keep``, a dict, receives the
    graphed engine under "engine"."""
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
    if keep is not None:
        keep["engine"] = engine
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


class PathWindow:
    """A main path's counter window that also keeps the shape of every
    call the deploy dispatch makes to K1, K2 and K3: ``start`` zeroes the
    counters and wraps ``ops``' names of the three wrappers with a
    recorder; ``stop`` reads the counters and puts the wrappers back.
    ``shapes`` holds (kernel, M, K, N, x dtype) of every call."""

    NAMES = ("dequant_matmul_w4", "dequant_matmul_w8", "qmatmul_int8")

    def __init__(self, torch):
        self.torch, self.shapes, self.counts, self._real = torch, set(), None, {}

    def start(self):
        from repro_torch.kernels import ops
        for name in self.NAMES:
            real = self._real[name] = getattr(ops, name)

            def record(x, b, *args, _name=name, _real=real, **kwargs):
                self.shapes.add((_name, x.shape[0], x.shape[1], b.shape[1],
                                 str(x.dtype).replace("torch.", "")))
                return _real(x, b, *args, **kwargs)

            setattr(ops, name, record)
        ops.reset_launch_counts()

    def stop(self):
        from repro_torch.kernels import ops
        self.torch.cuda.synchronize()
        self.counts = ops.launch_counts()
        for name, real in self._real.items():
            setattr(ops, name, real)
        return self.counts


def check_path_shapes(torch, window, rows, where):
    """Every shape a path's window gave K1, K2 or K3 (``PathWindow``) that
    no row of ``rows`` already held: the wrapper against its plain version
    at that shape. Returns the new rows, each naming ``where``."""
    from repro_torch.kernels import dequant_matmul_w4 as k12
    from repro_torch.kernels import qmatmul_int8 as k3
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(3)
    held = {(r["kernel"], r["M"], r["K"], r["N"], r["x"]) for r in rows
            if r["kernel"] in PathWindow.NAMES and not r.get("misaligned")
            and r.get("codes", "random") == "random"}
    new = []
    for shape in sorted(window.shapes - held):
        name, M, K, N, x = shape
        if name == "qmatmul_int8":
            new.append(check_int8(torch, k3, ref, M, K, N, gen, timed=False))
        else:
            new.append(check_dequant(torch, k12, ref, name, M, K, N,
                                     getattr(torch, x), gen, False))
        new[-1]["path"] = where
    torch.cuda.empty_cache()
    log(f"{where}: {len(window.shapes)} kernel shapes on the path, "
        f"{len(window.shapes) - len(new)} held by the kernels phase, "
        f"{len(new)} more held against their plain versions: "
        + ", ".join(f"{r['kernel']} {r['M']}x{r['K']}x{r['N']} "
                    f"{r.get('regime', 'int8')} {r['max_abs_err']:.3e}"
                    for r in new))
    return new


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
    return dict(_tie_agreement(torch, res["auto"][0], res["torch"][0],
                               torch.as_tensor(generated, device=DEV)),
                routes=(res["auto"][1], res["torch"][1]))


def path_phase(torch, np, arch="smollm-135m", n_layers=None, w8_layers=(0, 29),
               tag="smollm"):
    """A dense path at full width (``n_layers`` of its layers, default all):
    export-only PTQ (W4 body, W8 ``w8_layers``, A8) on 8 x 64 tokens, then
    ``serve_phase``; the export must launch K1 and K3, serving K1 and K2,
    and K1 and K2 each run in both regimes; request 0 is re-run plain."""
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 64)), device=DEV)
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_granularity="per_channel", iters=0,
                         rules=tuple(f"layers.{i}.*:w_bits=8"
                                     for i in w8_layers))
    torch.cuda.synchronize()
    log(f"path: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}) initialised in "
        f"{time.perf_counter() - t0:.2f}s, {torch.cuda.memory_allocated()} B")
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()  # the main path's run starts here
    fin, astates, export_s, errs, _ = export(torch, model, params, calib,
                                             recipe, list(w8_layers))
    export_counts = ops.launch_counts()
    log(f"export launches {export_counts}")
    if export_counts["dequant_matmul_w4"] == 0 or export_counts["qmatmul_int8"] == 0:
        fail(f"export pass did not launch K1 and K3: {export_counts}")
    qparams = dict(params, layers=list(fin))
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    keep = {}
    counts, requests, outs, stats = serve_phase(
        torch, np, model, qparams, ctx, export_counts, tag, keep)
    serve_counts = stats["serve_launches"]
    if serve_counts["dequant_matmul_w4"] == 0 or serve_counts["dequant_matmul_w8"] == 0:
        fail(f"serving did not launch K1 and K2: {serve_counts}")
    require_regimes(counts, f"the {cfg.name} path")
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
    analysis = None
    if tag == "smollm":
        analysis = analysis_path_checks(torch, model, qparams, ctx,
                                        keep["engine"], requests, outs)
    del keep
    return counts, dict(stats, export_s=export_s, max_memory_allocated=peak,
                        err=errs, export_launches=export_counts,
                        serve_launches=serve_counts, recheck=rc,
                        analysis=analysis)


def launcher_argv(iters: int, arch: str = "smollm-135m", last: int = 29):
    """The launcher's recipe for the trained, preemption and olmo phases:
    ``arch`` at full width and depth, W4 body, W8 layers 0 and ``last``,
    A8, QDrop, 64 x 64 calibration tokens (``--calib``/``--seq`` defaults),
    the launcher's lr 3e-3 and minibatches of min(16, calib) = 16."""
    return ["--arch", arch, "--w-bits", "4", "--a-bits", "8",
            "--rule", "layers.0.*:w_bits=8", "--rule",
            f"layers.{last}.*:w_bits=8", "--setting", "qdrop", "--iters",
            str(iters), "--calib", "64", "--seq", "64"]


def _first_curve_diff(np, a, b):
    """(report index, step) of the first loss or MSE entry that differs."""
    for i, (p, q) in enumerate(zip(a, b)):
        for x, y in ((p.loss_curve, q.loss_curve), (p.mse_curve, q.mse_curve)):
            bad = np.flatnonzero(np.asarray(x) != np.asarray(y))
            if len(bad):
                return i, int(bad[0])
    return None


def recon_graphs_equal(torch, np, blocks, recipe, x0, engines, where):
    """``quantize_blocks`` over ``blocks`` twice from the same seed:
    ``graphs=False``, then graphed. ``engines`` engines must be built on
    each side and as many steps captured on the graphed one; loss and MSE
    curves, errors, activation states and exported codes, scales and zeros
    must be equal bit for bit (the first differing step is reported if
    not). Returns ({"eager", "graph"}: seconds, steps/s, engine counters,
    capture seconds), [(err_before, err_after)] per block)."""
    from repro_torch.core import reconstruct as rc
    from repro_torch.obs import compile_events
    runs, res = {}, {}
    for graphs, tag in ((False, "eager"), (None, "graph")):
        rc.reset_engine_stats()
        n_caps = len(compile_events.capture_seconds("recon.step"))
        t0 = time.perf_counter()
        runs[tag] = rc.quantize_blocks(blocks, recipe, x0, graphs=graphs)
        torch.cuda.synchronize()
        st = rc.engine_stats()
        reps = runs[tag][2]
        caps = compile_events.capture_seconds("recon.step")[n_caps:]
        res[tag] = {"seconds": time.perf_counter() - t0,
                    "steps_per_s": [r.steps_per_s for r in reps],
                    "engine_stats": dataclasses.asdict(st),
                    "capture_s": caps}
        log(f"recon graphs [{tag}]: {where} in {res[tag]['seconds']:.2f}s, "
            "steps/s " + " ".join(f"{v:.1f}" for v in res[tag]["steps_per_s"])
            + f"; step captures {len(caps)} "
            f"({' '.join(f'{c:.3f}s' for c in caps)}), engines "
            f"{st.engine_builds} built")
        if st.engine_builds != engines or st.step_compiles != len(caps) or \
                len(caps) != (engines if graphs is None else 0) or \
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
    log(f"recon graphs: graphed against graphs=False, {where} x "
        f"{recipe.iters} steps: {len(diff)} tensors differ, first curve "
        f"difference {step}; errors {errs}")
    if diff or step is not None:
        fail(f"recon graphs: the replayed step differs from the eager one: "
             f"{diff[:10]}, first curve difference (block, step) {step}")
    return res, errs


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
    from repro_torch.obs import profiler

    args = launcher.build_parser().parse_args(launcher_argv(TRAIN_ITERS))
    recipe = launcher.build_recipe(args)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    calib = torch.as_tensor(CalibrationSet.build(SyntheticTokens(
        vocab=cfg.vocab, seq_len=args.seq, seed=0), args.calib).tokens).to(DEV)
    x0, blocks, _ = model.quant_blocks(params, calib)
    res, errs = recon_graphs_equal(torch, np, blocks[:2], recipe, x0, 2,
                                   "blocks 0-1")

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


def run_launcher(torch, argv):
    """``repro_torch.launch.quantize.main(argv)`` in process with the launch
    counters zeroed just before the call and read just after; its
    ``serve_engine_run`` is wrapped to read them where the export ends and
    serving begins. Returns (result, counts, export counts, serve counts,
    export seconds, launcher seconds, max_memory_allocated)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as launcher

    from repro_torch.core import reconstruct as rc
    from repro_torch.obs import compile_events

    marks = {}
    real_serve, real_analyze = launcher.serve_engine_run, launcher.analyze

    def serve_engine_run(*args, **kwargs):
        torch.cuda.synchronize()
        marks["export"] = ops.launch_counts()
        marks["export_s"] = time.perf_counter() - t0
        return real_serve(*args, **kwargs)

    def analyze(*args, **kwargs):
        # the launcher path's run ends where --analyze starts: its
        # counters, engine stats and captures are read here
        torch.cuda.synchronize()
        marks.update(end=ops.launch_counts(), end_s=time.perf_counter() - t0,
                     engine=dataclasses.replace(rc.engine_stats()),
                     step_captures=len(compile_events.capture_seconds(
                         "recon.step")),
                     peak=torch.cuda.max_memory_allocated())
        t1 = time.perf_counter()
        real_analyze(*args, **kwargs)
        marks["analyze_s"] = time.perf_counter() - t1

    torch.cuda.reset_peak_memory_stats()
    launcher.serve_engine_run = serve_engine_run
    launcher.analyze = analyze
    try:
        ops.reset_launch_counts()  # the launcher path's run starts here
        t0 = time.perf_counter()
        res = launcher.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()  # the launcher path's run ends here
        launcher_s = time.perf_counter() - t0
    finally:
        launcher.serve_engine_run = real_serve
        launcher.analyze = real_analyze
    if "end" in marks:
        counts, launcher_s = marks["end"], marks["end_s"]
        res.analyze_marks = marks
    export_counts = marks["export"]
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    return (res, counts, export_counts, serve_counts, marks["export_s"],
            launcher_s, marks.get("peak", torch.cuda.max_memory_allocated()))


def validate_telemetry(path: Path) -> None:
    """``python -m repro_torch.obs.sink --validate`` on a launcher's
    telemetry file: the run fails unless the sink CLI exits 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.sink",
                           "--validate", str(path)], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    log(f"telemetry: repro_torch.obs.sink --validate exited "
        f"{proc.returncode}: {proc.stdout.strip()}")
    if proc.returncode != 0:
        fail(f"telemetry: the sink CLI refused {path}: "
             f"{(proc.stdout + proc.stderr)[-2000:]}")


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
    from repro_torch.obs import compile_events

    n_caps = len(compile_events.capture_seconds("recon.step"))
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    argv = launcher_argv(TRAIN_ITERS) + [
        "--resume-dir", str(RUNS_DIR / "trained_ckpt"),
        "--out", str(RUNS_DIR / "trained_export"), "--serve", "--analyze-mem",
        "--telemetry", str(TELEMETRY_DIR)]
    log("trained: python -m repro_torch.launch.quantize " + " ".join(argv))
    (res, counts, export_counts, serve_counts, export_s, launcher_s,
     peak) = run_launcher(torch, argv)  # exits non-zero on a finding
    validate_telemetry(TELEMETRY_DIR / "events.jsonl")
    marks = res.analyze_marks
    log(f"trained: --analyze-mem ran {marks['analyze_s']:.2f}s after the "
        "launcher's run and found no error")
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
    # the launcher zeroed the stats before its run; read where --analyze
    # started (its retrace check builds and captures toy engines)
    st = marks["engine"]
    caps = compile_events.capture_seconds("recon.step")[
        n_caps:marks["step_captures"]]
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
        launcher_s=launcher_s, analyze_s=marks["analyze_s"],
        export_s=export_s, loop_s=loop_s, steps=steps,
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
    """``preempt_and_resume`` on smollm-135m's launcher command at
    PREEMPT_ITERS iterations, killed once block PREEMPT_AT is saved."""
    res = preempt_and_resume(torch, launcher_argv(PREEMPT_ITERS), PREEMPT_AT,
                             "preempt")
    res.pop("result")
    return dict(res, iters=PREEMPT_ITERS)


def preempt_and_resume(torch, argv, kill_at, tag, window=None):
    """A launcher run killed mid-way resumes to the same export, bit for bit:
    (1) ``argv`` in process, without a break, to export A; (2) the same
    command in a subprocess with ``--resume-dir D --out B``, sent SIGKILL
    once D's checkpoint records ``next_block >= kill_at``; (3) the same
    command in process, resuming from D, to B. Every tensor of B (codes,
    scales, zeros, the fp leaves, the activation states) must equal A's bit
    for bit, and every block's err_before and err_after too (the killed
    process's blocks come from its checkpoint). Returns the seconds, the
    block killed at, the blocks resumed, A's errors and its
    ``LaunchResult`` (``"result"``). A ``PathWindow`` is started just
    before run (1) and stopped just after it: run (1) is the main path."""
    import os
    import signal

    from repro_torch.checkpoint import PTQCheckpointer, load_pytree
    from repro_torch.launch import quantize as launcher

    ckpt, out_a, out_b = (str(RUNS_DIR / f"{tag}_{n}") for n in
                          ("ckpt", "a", "b"))
    secs = {}
    t0 = time.perf_counter()
    if window is not None:
        window.start()
    res_a = launcher.main(argv + ["--out", out_a])
    if window is not None:
        window.stop()
    torch.cuda.synchronize()
    secs["uninterrupted"] = time.perf_counter() - t0

    log_path = RUNS_DIR / f"{tag}_child.log"
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
                if meta is not None and meta["next_block"] >= kill_at:
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
                err=errs_a, err_after_sum=sum(b for _, b in errs_a),
                result=res_a)


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
    from repro_torch.analysis.diffcheck import matmul_tol
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or not bool(
            (err <= matmul_tol(x, None, want, K)).all()):
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

def olmo_phase(torch, np):
    """olmo-1b at full width and depth (16 layers, d_model 2048, 16 heads =
    16 KV heads, d_ff 8192, vocab 50304, untied head, non-parametric
    LayerNorm, bfloat16) through the launcher, in process: the trained
    phase's command (``launcher_argv``: W4 body, W8 layers 0 and 15, A8,
    QDrop, OLMO_ITERS iterations, per-block checkpoints, ``--serve``).
    Counters zeroed before the call and read after it (split where serving
    starts): the export must launch K1 and K3, serving K1 and K2. The error
    sum must fall below its start. Then the export serves the 8 requests of
    ``serve_requests`` through the graphed engine and the eager one
    (identical tokens and launches), and request 0 is re-run plain."""
    from repro_torch.core.context import QuantCtx
    from repro_torch.kernels import ops

    argv = launcher_argv(OLMO_ITERS, "olmo-1b", OLMO_LAST) + [
        "--resume-dir", str(RUNS_DIR / "olmo_ckpt"),
        "--out", str(RUNS_DIR / "olmo_export"), "--serve"]
    log("olmo: python -m repro_torch.launch.quantize " + " ".join(argv))
    (res, counts, export_counts, serve_counts, export_s, launcher_s,
     peak) = run_launcher(torch, argv)
    cfg, qparams, reports = res.cfg, res.qparams, res.reports
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
             cfg.vocab, cfg.norm, cfg.tie_embeddings, cfg.dtype)
    if shape != (16, 2048, 16, 16, 8192, 50304, "layernorm_nonparam", False,
                 "bfloat16") or "final_norm" in qparams or any(
                     k in layer for layer in qparams["layers"]
                     for k in ("ln1", "ln2")):
        fail(f"olmo: config {shape} or a norm key in its tree")
    got_w8 = sorted(i for i, layer in enumerate(qparams["layers"])
                    if any(qt.bits == 8 for qt in _qtensors(layer)))
    errs = [(r.err_before, r.err_after) for r in reports]
    before = sum(a for a, _ in errs)
    after = sum(b for _, b in errs)
    steps = sum(r.iters for r in reports)
    loop_s = sum(r.iters / r.steps_per_s for r in reports)
    log(f"olmo: launcher {launcher_s:.2f}s, {steps} steps, export (to the "
        f"serve run) {export_s:.2f}s, {loop_s:.2f}s in the Adam loops, "
        f"{steps / loop_s:.1f} steps/s, max_memory_allocated {peak} B")
    log("olmo err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"olmo: sum of err_before {before:.6e}, sum of err_after {after:.6e}")
    if got_w8 != [0, OLMO_LAST] or len(reports) != cfg.n_layers or not all(
            math.isfinite(a) and math.isfinite(b) for a, b in errs) or \
            not after < before:
        fail(f"olmo: W8 layers {got_w8}, {len(reports)} reports, errors "
             f"{before} -> {after}")
    log(f"olmo export launches {export_counts}")
    log(f"olmo serve launches {serve_counts}")
    if export_counts["dequant_matmul_w4"] == 0 or export_counts["qmatmul_int8"] == 0:
        fail(f"olmo export did not launch K1 and K3: {export_counts}")
    if serve_counts["dequant_matmul_w4"] == 0 or serve_counts["dequant_matmul_w8"] == 0:
        fail(f"serving olmo did not launch K1 and K2: {serve_counts}")
    served = res.serve
    st, outs = served["stats"], served["outputs"]
    n_tok = sum(len(v) for v in outs.values())
    sched = {"serve_s": served["seconds"],
             "tokens_per_s": n_tok / served["seconds"],
             "decode_steps": st["decode_steps"],
             "decode_ms_per_step": st["requests"]["decode_step_us"]["mean"] / 1e3,
             "compile_count": st["compile_count"],
             "hbm_per_slot_bytes": st["hbm_per_slot_bytes"]}
    log(f"olmo serve (scheduler): {n_tok} tokens in {served['seconds']:.3f}s "
        f"-> {sched['tokens_per_s']:.1f} tokens/s, {st['decode_steps']} decode "
        f"steps of {sched['decode_ms_per_step']:.2f} ms (mean), compile_count "
        f"{st['compile_count']}")
    if st["compile_count"] != 4:
        fail(f"olmo serve: compile_count {st['compile_count']}")

    ctx = QuantCtx(mode="deploy", recipe=res.recipe, astates=res.astates)
    before_c = ops.launch_counts()
    requests, outs_g, graphed, _ = run_engine(torch, np, res.model, qparams,
                                              ctx)
    after_c = ops.launch_counts()
    graphed_counts = {k: after_c[k] - before_c[k] for k in after_c}
    eager, _ = compare_eager(torch, np, res.model, qparams, ctx, outs_g,
                             graphed_counts)
    rc = recheck_request0(torch, res.model, qparams, res.recipe, res.astates,
                          requests, outs_g)
    rc.pop("routes")
    log(f"olmo: torch backend re-run of request 0: logits relative L2 diff "
        f"{rc['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rc['max_abs_diff']:.4e}; greedy tokens {rc['greedy_agree']}/"
        f"{rc['n_tokens']} identical")
    if not math.isfinite(rc["rel_l2"]) or rc["rel_l2"] > 5e-2 or not rc["ties_ok"]:
        fail("olmo: kernel and plain-version serving disagree beyond bf16 "
             "tolerance")
    return counts, dict(
        sched, argv=argv, launcher_s=launcher_s, export_s=export_s,
        loop_s=loop_s, steps=steps, steps_per_s=steps / loop_s,
        max_memory_allocated=peak, err=errs, err_before_sum=before,
        err_after_sum=after, export_launches=export_counts,
        serve_launches=serve_counts, graphed=graphed, eager=eager, recheck=rc)


# ----------------------------------------------------------- deepseek path
def _uniform_prefill(model, params, ctx, prompt, max_len, frames, kv_quant):
    """A fresh cache (int8 with ``kv_quant``) filled by ``prefill``; an
    encoder-decoder also takes its ``frames`` (B, enc_len, D)."""
    B = prompt.shape[0]
    if frames is None:
        cache = model.init_cache(B, max_len, kv_quant=kv_quant, device=DEV)
        return model.prefill(params, prompt, cache, ctx)
    cache = model.init_cache(B, max_len, frames.shape[1], kv_quant=kv_quant,
                             device=DEV)
    return model.prefill(params, prompt, frames, cache, ctx)


def uniform_greedy(torch, model, params, ctx, prompt, steps, frames=None,
                   kv_quant=False):
    """Uniform-batch greedy decode (the path of the launcher's
    ``serve_smoke``): prefill ``prompt`` (B, S), then ``steps`` decode
    steps. Returns (tokens (B, steps + 1) generated, logits (steps + 1, B,
    V) in float32, {"us_per_step": decode steps timed between host syncs,
    "cache_bytes"})."""
    from repro_torch.serve import kv as skv
    B, S = prompt.shape
    last, cache = _uniform_prefill(model, params, ctx, prompt, S + steps + 1,
                                   frames, kv_quant)
    logits = [model.logits(params, last)[:, -1].float()]
    toks = [logits[0].argmax(-1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, cache = model.decode_step(params, toks[-1][:, None], cache, S + i,
                                      ctx)
        logits.append(lg[:, -1].float())
        toks.append(logits[-1].argmax(-1))
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6 / max(steps, 1)
    return (torch.stack(toks, 1), torch.stack(logits),
            {"us_per_step": us, "cache_bytes": skv.cache_bytes(cache)})


def uniform_forced(torch, model, params, ctx, prompt, generated, frames=None,
                   kv_quant=False):
    """Logits along a fixed token path: prefill of ``prompt``, then one
    decode step per generated token but the last."""
    B, S = prompt.shape
    last, cache = _uniform_prefill(model, params, ctx, prompt,
                                   S + generated.shape[1], frames, kv_quant)
    out = [model.logits(params, last)[:, -1].float()]
    for i in range(generated.shape[1] - 1):
        lg, cache = model.decode_step(params, generated[:, i:i + 1], cache,
                                      S + i, ctx)
        out.append(lg[:, -1].float())
    return torch.stack(out)


def profile_uniform(torch, model, params, ctx, prompt, tag, frames=None,
                    kv_quant=False, steps=8):
    """``steps`` uniform-batch decode steps after ``prompt``'s prefill and
    two untraced steps, each annotated ``uniform.decode_step`` and traced
    with obs.profiler: the device-busy share of their window, the device
    ops in it and the top 5 (``device_window``), and the host's ms per
    traced step."""
    from repro_torch.obs import profiler
    B, S = prompt.shape
    d = RUNS_DIR / f"profile_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    with torch.no_grad():
        last, cache = _uniform_prefill(model, params, ctx, prompt,
                                       S + steps + 2, frames, kv_quant)
        tok = model.logits(params, last)[:, -1].argmax(-1)[:, None]
        for i in range(2):
            _, cache = model.decode_step(params, tok, cache, S + i, ctx)
        torch.cuda.synchronize()
        with profiler.trace(str(d)):
            t0 = time.perf_counter()
            for i in range(steps):
                with profiler.annotate("uniform.decode_step", i):
                    _, cache = model.decode_step(params, tok, cache,
                                                 S + 2 + i, ctx)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    win = device_window(d, "uniform.decode_step")
    res = {"steps": win.pop("marks"), "wall_ms_per_step": 1e3 * wall_s / steps,
           **win}
    share = res["device_busy_share"]
    log(f"profile [{tag}]: {res['steps']} uniform decode steps, window "
        f"{res['window_ms']:.3f} ms, device busy {res['device_busy_ms']:.3f} "
        f"ms ({'not measured' if share is None else f'{100 * share:.1f}%'}), "
        f"{res['device_ops']} device ops, {res['host_syncs']} host syncs, "
        f"{res['copies_to_device']} copies to the device, "
        f"{res['wall_ms_per_step']:.3f} ms per traced step; top 5: "
        + "; ".join(
            f"{t['name'][:60]} {t['ms']:.3f} ms" for t in res["top5"]))
    return res


def _tie_agreement(torch, lk, lt, generated):
    """Kernel logits ``lk`` against plain ones ``lt`` (..., V) along the
    greedy path ``generated`` (...,): relative L2, max |diff|, greedy
    tokens of the plain run equal to the path, and whether every other one
    is a near-tie: a greedy token may differ only where the plain run's
    logit of the path's token lies within twice the largest deviation of
    its top logit."""
    rel = ((lk - lt).norm() / lt.norm()).item()
    dev = (lk - lt).abs().max().item()
    near = lt.gather(-1, generated[..., None])[..., 0]
    ties_ok = bool((near >= lt.max(dim=-1).values - 2 * dev).all())
    agree = int((lt.argmax(dim=-1) == generated).sum())
    return {"rel_l2": rel, "max_abs_diff": dev, "ties_ok": ties_ok,
            "greedy_agree": agree, "n_tokens": int(generated.numel())}


def deepseek_loss_check(torch, np):
    """``model.loss`` with the mtp head on the reduced config in float32
    (one dense and one MoE layer, d_model 64, vocab 128; B = 2, S = 200:
    7 chunks of 32, the last padded) against ``plain_loss`` (unchunked
    ``cross_entropy`` for both heads): the loss and ``mtp_ce`` within
    relative 1e-5, the gradients of the embedding, the head, ``mtp.proj``
    and two MLA weights within 1e-4 of the largest |gradient| each."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("deepseek-v3-671b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(2)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 200)),
                                device=DEV) for k in ("tokens", "labels")}
    watched = {"embed": params["embed"], "lm_head": params["lm_head"],
               "mtp.proj": params["mtp"]["proj"],
               "dense_layers.0.attn.wkv_b":
                   params["dense_layers"][0]["attn"]["wkv_b"],
               "layers.0.attn.wq_b": params["layers"][0]["attn"]["wq_b"]}
    leaves = _leaves(torch, params)
    for t in leaves:
        t.requires_grad_(True)
    ctx = QuantCtx(mode="fp")
    runs = {}
    for tag, fn in (("chunked", lambda: model.loss(params, batch, ctx)),
                    ("plain", lambda: plain_loss(torch, model, params, batch,
                                                 ctx))):
        for t in leaves:
            t.grad = None
        loss, m = fn()
        loss.backward()
        runs[tag] = (loss.item(), m["mtp_ce"].item(),
                     {k: v.grad.detach().clone() for k, v in watched.items()})
    (lc, mc, gc_), (lp, mp, gp) = runs["chunked"], runs["plain"]
    rel, mrel = abs(lc - lp) / abs(lp), abs(mc - mp) / abs(mp)
    gdiff = {k: ((gc_[k] - gp[k]).abs().max() / gp[k].abs().max()).item()
             for k in watched}
    log(f"deepseek loss [reduced, float32, B=2, S=200]: chunked {lc:.6f} "
        f"(mtp_ce {mc:.6f}), plain {lp:.6f} (mtp_ce {mp:.6f}), relative "
        f"difference {rel:.3e} / {mrel:.3e} (tolerance 1e-5); largest "
        "gradient difference over the largest gradient: " + ", ".join(
            f"{k} {v:.3e}" for k, v in gdiff.items()) + " (tolerance 1e-4)")
    if not (math.isfinite(lc) and rel <= 1e-5 and mrel <= 1e-5
            and all(v <= 1e-4 for v in gdiff.values())):
        fail("deepseek loss: the chunked loss, mtp_ce or the gradients "
             "disagree with the plain cross entropy")
    return {"loss": lc, "plain_loss": lp, "mtp_ce": mc, "plain_mtp_ce": mp,
            "rel_diff": rel, "mtp_rel_diff": mrel, "grad_rel_diff": gdiff}


def _leaves(torch, tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(torch, v)]


def deepseek_launcher_check(torch):
    """The reduced deepseek-v3 through the launcher on the card: W4A8
    FlexRound with QDrop over both segments (dense block layers.0, MoE
    block layers.1), DEEPSEEK_SMOKE_ITERS iterations, ``--serve-smoke
    --serve`` (the engine's skip line), through ``preempt_and_resume``
    with the kill after block 0's checkpoint; the error sum must fall, the
    uniform-batch decode run and the engine refuse."""
    argv = ["--arch", "deepseek-v3-671b", "--smoke", "--w-bits", "4",
            "--a-bits", "8", "--setting", "qdrop", "--iters",
            str(DEEPSEEK_SMOKE_ITERS), "--calib", "16", "--seq", "32",
            "--serve-smoke", "--serve"]
    res = preempt_and_resume(torch, argv, 1, "deepseek_smoke")
    run = res.pop("result")
    errs = res["err"]
    before, after = sum(x for x, _ in errs), sum(y for _, y in errs)
    log(f"deepseek launcher [smoke, {DEEPSEEK_SMOKE_ITERS} iterations, "
        f"QDrop W4A8]: blocks {[r.name for r in run.reports]}, "
        f"err_before/err_after " + " ".join(f"{x:.4e}/{y:.4e}"
                                             for x, y in errs)
        + f"; serve-smoke {run.serve_smoke_us:.1f} us/step; killed at block "
        f"{res['killed_at']}, {res['resumed_blocks']} resumed")
    if len(errs) != 2 or not after < before or run.serve is not None or \
            not math.isfinite(run.serve_smoke_us):
        fail(f"deepseek launcher: errors {before} -> {after}, serve "
             f"{run.serve}, serve-smoke {run.serve_smoke_us}")
    return dict(res, err_before_sum=before, err_after_sum=after,
                serve_smoke_us=run.serve_smoke_us)


def deepseek_phase(torch, np):
    """deepseek-v3-671b at full width (d_model 7168, 128 heads, MLA with q
    rank 1536 and kv rank 512, d_ff 18432, 256 experts top-8 of width 2048
    and a shared expert, vocab 129280) with DEEPSEEK_LAYERS = 4 of its 61
    layers (the published 3 leading dense layers and 1 MoE layer) and no
    mtp head, bfloat16, weights from torch.Generator seed 0. First block 0
    (a dense MLA layer) is reconstructed for DEEPSEEK_RECON_ITERS FlexRound
    iterations (W4A8, QDrop) through the captured engine and with
    graphs=False: equal bit for bit, its error falling. Then the main
    path: export-only PTQ (W4 body, W8 layer 0, A8, per-channel, mse
    observer; RTN on the 256-expert stacks, which exports FlexRound's codes
    at iters 0) on 8 x 64 tokens, and the launcher's ``serve_smoke`` (batch
    2, 16 prompt tokens, 8 decode steps through the absorbed decode), the
    counters zeroed just before and read just after: K1, K2 and K3 must
    launch, K1 and K2 in both regimes, K5 packed in the mma (export) and
    decode (serving) regimes. The prompt is decoded greedily with the
    kernels and re-run along the same tokens with the plain versions
    (logits relative L2, greedy tokens, routing flips). The slot engine
    must refuse the model (``unsupported_layout:mla``) and the int8 cache
    too (``kv_quant_unsupported:mla``). Then the mtp loss on the reduced
    config and the reduced config through the launcher
    (``deepseek_loss_check``, ``deepseek_launcher_check``).
    max_memory_allocated of the full-width part must stay below 80 GB."""
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.qtensor import tree_weight_bytes
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as launcher
    from repro_torch.models.model import build_model
    from repro_torch.serve import kv as skv
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=DEEPSEEK_LAYERS, mtp=False)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 64)), device=DEV)
    torch.cuda.synchronize()
    wbytes = tree_weight_bytes(params)
    log(f"deepseek path: {cfg.name} ({len(params['dense_layers'])} dense + "
        f"{len(params['layers'])} MoE of 61 layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, MLA q/kv rank {cfg.q_lora_rank}/"
        f"{cfg.kv_lora_rank}, d_ff {cfg.d_ff}, {cfg.n_experts} experts "
        f"top-{cfg.top_k} of width {cfg.moe_d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}) initialised in {time.perf_counter() - t0:.2f}s, "
        f"weights {wbytes} B")

    # the paper's learned rounding on MLA's five sites and the dense MLP
    recon_recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                               w_granularity="per_channel", w_observer="mse",
                               iters=DEEPSEEK_RECON_ITERS, batch_size=8)
    x0, blocks, _ = model.quant_blocks(params, calib)
    recon, recon_errs = recon_graphs_equal(torch, np, blocks[:1],
                                           recon_recipe, x0, 1,
                                           "deepseek block 0")
    if not recon_errs[0][1] < recon_errs[0][0]:
        fail(f"deepseek block 0: error {recon_errs[0][0]} -> "
             f"{recon_errs[0][1]}")
    recon_peak = torch.cuda.max_memory_allocated()
    del x0, blocks
    gc.collect()
    torch.cuda.empty_cache()

    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_granularity="per_channel", w_observer="mse",
                         iters=0, rules=("layers.0.*:w_bits=8",
                                         "layers.3.experts.*:method=rtn"))
    ops.reset_launch_counts()  # the deepseek main path's run starts here
    fin, astates, export_s, errs, _ = export(torch, model, params, calib,
                                             recipe, [0])
    export_counts = ops.launch_counts()
    log(f"export launches {export_counts}")
    n_dense = len(params["dense_layers"])
    qparams = dict(params, dense_layers=fin[:n_dense], layers=fin[n_dense:])
    del params, fin
    gc.collect()
    torch.cuda.empty_cache()
    us = launcher.serve_smoke(model, qparams, astates, recipe, cfg,
                              device=DEV)
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # ... and ends here
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    log(f"serve-smoke launches {serve_counts}")
    need = {"export: K1": export_counts["dequant_matmul_w4"],
            "export: K3": export_counts["qmatmul_int8"],
            "export: K5 packed mma":
                min(export_counts["dequant_matmul_batched[packed]"],
                    export_counts["dequant_matmul_batched[mma]"]),
            "serve: K1": serve_counts["dequant_matmul_w4"],
            "serve: K2": serve_counts["dequant_matmul_w8"],
            "serve: K5 packed decode":
                min(serve_counts["dequant_matmul_batched[packed]"],
                    serve_counts["dequant_matmul_batched[decode]"])}
    if not all(need.values()) or \
            counts["dequant_matmul_batched[unpacked]"]:
        fail(f"the deepseek path did not launch every kernel: {need}, "
             f"{counts}")
    require_regimes(counts, "the deepseek path")
    peak = torch.cuda.max_memory_allocated()

    # the slot engine and the int8 cache refuse MLA with their reasons
    refused = {}
    for what, call in (
            ("engine", lambda: ServeEngine(model, qparams, QuantCtx(
                mode="deploy", recipe=recipe, astates=astates))),
            ("kv_quant", lambda: model.init_cache(2, 8, kv_quant=True))):
        try:
            call()
        except skv.KVQuantUnsupported as e:
            refused[what] = e.reason
    engine_run = launcher.serve_engine_run(model, qparams, astates, recipe,
                                           cfg, device=DEV)
    log(f"deepseek refusals: {refused}; serve_engine_run -> {engine_run}")
    if refused != {"engine": "unsupported_layout:mla",
                   "kv_quant": "kv_quant_unsupported:mla"} or \
            engine_run is not None:
        fail(f"deepseek: refusals {refused}, serve_engine_run {engine_run}")

    # the prompt of serve_smoke decoded greedily with the kernels, then
    # along the same tokens with the plain versions
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(
        ).manual_seed(0)).to(DEV)
    res = {}
    for backend in ("auto", "torch"):
        ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                       backend=backend)
        with torch.no_grad(), RouteLog() as rl:
            if backend == "auto":
                toks, lg, _ = uniform_greedy(torch, model, qparams, ctx,
                                             prompt, 8)
            else:
                lg = uniform_forced(torch, model, qparams, ctx, prompt, toks)
        res[backend] = (lg, rl.idx)
    torch.cuda.synchronize()
    (lk, rk), (lt, rt) = res["auto"], res["torch"]
    tie = _tie_agreement(torch, lk, lt, toks.T)
    rel, dev, agree = tie["rel_l2"], tie["max_abs_diff"], tie["greedy_agree"]
    flips = sum(int((a != b).sum()) for a, b in zip(rk, rt))
    decisions = sum(a.numel() for a in rk)
    finite = bool(torch.isfinite(lk).all())
    log(f"deepseek serve-smoke {us:.1f} us/step; greedy tokens "
        f"{toks.tolist()}; torch backend re-run: logits relative L2 diff "
        f"{rel:.4e}, max |diff| {dev:.4e}; routing decisions that differ "
        f"{flips}/{decisions}; greedy tokens {agree}/{toks.numel()} identical")
    # 4 layers rounded to bf16 in different places drift little; only a
    # flipped top-k expert at a near-tie may move the logits by O(1)
    if not finite or len(rk) != len(rt) or not math.isfinite(rel) or (
            flips == 0 and rel > 5e-2) or lk.shape != (9, 2, cfg.vocab):
        fail("deepseek: kernel and plain-version serving disagree beyond "
             "bf16 tolerance without a routing flip")
    log(f"deepseek: max_memory_allocated {peak} B (recon check {recon_peak} "
        f"B), export {export_s:.2f}s")
    if max(peak, recon_peak) >= 80e9:
        fail(f"deepseek: peak device memory {peak} B")
    del qparams, astates, res, lk, lt
    gc.collect()
    torch.cuda.empty_cache()
    loss = deepseek_loss_check(torch, np)
    smoke = deepseek_launcher_check(torch)
    return counts, {
        "weights_bytes": wbytes,
        "recon_block0": dict(recon, errors=recon_errs),
        "export_s": export_s, "err": errs, "export_launches": export_counts,
        "serve_launches": serve_counts, "serve_smoke_us": us,
        "max_memory_allocated": peak, "recon_max_memory_allocated": recon_peak,
        "refused": refused,
        "recheck": {"rel_l2": rel, "max_abs_diff": dev,
                    "routing_decisions": decisions, "routing_flips": flips,
                    "greedy_agree": agree, "n_tokens": toks.numel()},
        "loss": loss, "launcher_smoke": smoke}


# ------------------------------------------------------------ whisper path
def whisper_phase(torch, np, rows):
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads, d_ff 4096, vocab 51865, LayerNorm,
    GELU, biased projections; 769 M weights, 1.5 GB of bf16), weights from
    torch.Generator seed 0, frame embeddings (the audio stub's input)
    N(0, 1) from seed 1 in bf16: WHISPER_CALIB x 1504 x 1024, with
    WHISPER_CALIB x 64 calibration tokens. The recipe: FlexRound W4 body,
    W8 layers 0 and 23, A8, per-channel, mse observer, QDrop, minibatches of
    WHISPER_CALIB (the whole set: the limit the baked encoder output sets).
    First block 0's WHISPER_BLOCK0_ITERS iterations graphed against
    graphs=False, bit for bit. Then the main path, counters zeroed just
    before and read just after: all 24 decoder blocks at WHISPER_ITERS
    iterations through the captured engine (the error sum must fall; the
    export's deploy forwards must launch K1 in the mma regime and K3),
    then uniform-batch serving (WHISPER_SERVE: batch 4, 16 prompt tokens,
    16 greedy steps over 1504 frames) with the int8 self and cross caches
    and with bf16 ones (the int8 caches must take fewer bytes); K1 and K2
    must each run in both regimes. Request 0 is re-run along its int8 path
    with the kernels and with the plain versions; the slot engine must
    refuse the family (``unsupported_family:encdec``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_medium import WHISPER_CROSS_LEN
    from repro_torch.core import reconstruct as rc
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.qtensor import tree_weight_bytes
    from repro_torch.core.quant_config import QuantRecipe
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve import kv as skv
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config("whisper-medium")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(1)
    frames = torch.randn((WHISPER_CALIB, WHISPER_CROSS_LEN, cfg.d_model),
                         generator=gen, device=DEV).to(torch.bfloat16)
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (WHISPER_CALIB, 64)), device=DEV)
    wbytes = tree_weight_bytes(params)
    log(f"whisper path: {cfg.name} ({cfg.enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}), weights {wbytes} B; frames {tuple(frames.shape)}")
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8,
                         w_granularity="per_channel", w_observer="mse",
                         iters=WHISPER_ITERS, batch_size=WHISPER_CALIB,
                         rules=("layers.0.*:w_bits=8",
                                f"layers.{cfg.n_layers - 1}.*:w_bits=8"))
    t0 = time.perf_counter()
    x0, blocks, assemble = model.quant_blocks(params, calib, frames)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    recon0, errs0 = recon_graphs_equal(
        torch, np, blocks[:1],
        dataclasses.replace(recipe, iters=WHISPER_BLOCK0_ITERS), x0, 1,
        "whisper block 0")

    window = PathWindow(torch)
    window.start()  # the whisper main path's run starts here
    rc.reset_engine_stats()
    t0 = time.perf_counter()
    fin, astates, reports = rc.quantize_blocks(blocks, recipe, x0)
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    export_counts = ops.launch_counts()
    st = rc.engine_stats()
    errs = [(r.err_before, r.err_after) for r in reports]
    before, after = sum(a for a, _ in errs), sum(b for _, b in errs)
    steps = sum(r.iters for r in reports)
    loop_s = sum(r.iters / r.steps_per_s for r in reports)
    got_w8 = sorted(i for i, layer in enumerate(fin)
                    if any(qt.bits == 8 for qt in _qtensors(layer)))
    log(f"whisper recon: {len(reports)} decoder blocks x {WHISPER_ITERS} "
        f"iterations in {recon_s:.2f}s ({loop_s:.2f}s in the Adam loops, "
        f"{steps / loop_s:.1f} steps/s; the encoder and x0 {encode_s:.2f}s); "
        f"engines {st.engine_builds} built, {st.engine_hits} reused, "
        f"{st.step_compiles} step captures")
    log("whisper err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"whisper: sum of err_before {before:.6e}, sum of err_after "
        f"{after:.6e}; export launches {export_counts}")
    if len(reports) != cfg.n_layers or got_w8 != [0, cfg.n_layers - 1] or \
            not all(math.isfinite(a) and math.isfinite(b) for a, b in errs) \
            or not after < before or {r.engine for r in reports} != {"graph"}:
        fail(f"whisper recon: {len(reports)} reports, W8 layers {got_w8}, "
             f"errors {before} -> {after}, engines "
             f"{[r.engine for r in reports]}")
    if export_counts["dequant_matmul_w4[mma]"] == 0 or \
            export_counts["qmatmul_int8"] == 0:
        fail(f"whisper export did not launch K1 (mma) and K3: "
             f"{export_counts}")
    qparams = assemble(fin)
    del x0, blocks, fin
    gc.collect()
    torch.cuda.empty_cache()

    B, S, n_new = WHISPER_SERVE
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)), device=DEV)
    sframes = torch.randn((B, WHISPER_CROSS_LEN, cfg.d_model), generator=gen,
                          device=DEV).to(torch.bfloat16)
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    served = {}
    with torch.no_grad():
        for kind, kvq in (("int8", True), ("bf16", False)):
            served[kind] = uniform_greedy(torch, model, qparams, ctx, prompt,
                                          n_new, sframes, kv_quant=kvq)
    counts = window.stop()  # ... and ends here
    serve_counts = {k: counts[k] - export_counts[k] for k in counts}
    log(f"whisper serve launches {serve_counts}")
    rows.extend(check_path_shapes(torch, window, rows, "whisper-medium"))
    if serve_counts["dequant_matmul_w4"] == 0 or \
            serve_counts["dequant_matmul_w8"] == 0:
        fail(f"whisper serving did not launch K1 and K2: {serve_counts}")
    require_regimes(counts, "the whisper path")
    (t8, l8, s8), (tb, lb, sb) = served["int8"], served["bf16"]
    same = int((t8 == tb).sum())
    log(f"whisper serve [batch {B}, {S} prompt tokens, {n_new} greedy steps, "
        f"enc_len {WHISPER_CROSS_LEN}]: int8 self+cross caches "
        f"{s8['us_per_step']:.1f} us/step, {s8['cache_bytes']} B; bf16 "
        f"caches {sb['us_per_step']:.1f} us/step, {sb['cache_bytes']} B; "
        f"greedy tokens equal {same}/{t8.numel()}")
    if not s8["cache_bytes"] < sb["cache_bytes"] or not (
            torch.isfinite(l8).all() and torch.isfinite(lb).all()) or \
            l8.shape != (n_new + 1, B, cfg.vocab):
        fail(f"whisper serve: cache bytes {s8['cache_bytes']} (int8) vs "
             f"{sb['cache_bytes']} (bf16), logits {tuple(l8.shape)}")

    # request 0 along its int8 greedy path: kernels, then plain versions
    res = {}
    with torch.no_grad():
        for backend in ("auto", "torch"):
            c = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                         backend=backend)
            res[backend] = uniform_forced(torch, model, qparams, c,
                                          prompt[:1], t8[:1], sframes[:1],
                                          kv_quant=True)[:, 0]
    rck = _tie_agreement(torch, res["auto"], res["torch"], t8[0])
    log(f"whisper: torch backend re-run of request 0: logits relative L2 "
        f"diff {rck['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rck['max_abs_diff']:.4e}; greedy tokens {rck['greedy_agree']}/"
        f"{rck['n_tokens']} identical, the others near-ties: "
        f"{rck['ties_ok']}")
    if not math.isfinite(rck["rel_l2"]) or rck["rel_l2"] > 5e-2 or \
            not rck["ties_ok"]:
        fail("whisper: kernel and plain-version serving disagree beyond "
             "bf16 tolerance")
    try:
        ServeEngine(model, qparams, ctx)
        refused = None
    except skv.KVQuantUnsupported as e:
        refused = e.reason
    prof = profile_uniform(torch, model, qparams, ctx, prompt, "whisper",
                           sframes, kv_quant=True)
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"whisper: the slot engine refused with {refused}; "
        f"max_memory_allocated {peak} B; phase {phase_s:.1f}s")
    if refused != "unsupported_family:encdec":
        fail(f"whisper: the slot engine answered {refused}")
    return counts, {
        "weights_bytes": wbytes, "encode_s": encode_s,
        "recon_block0": dict(recon0, errors=errs0), "recon_s": recon_s,
        "loop_s": loop_s, "steps": steps, "steps_per_s": steps / loop_s,
        "engine_stats": dataclasses.asdict(st), "err": errs,
        "err_before_sum": before, "err_after_sum": after,
        "export_launches": export_counts, "serve_launches": serve_counts,
        "serve": {k: v[2] for k, v in served.items()},
        "greedy_equal_int8_bf16": same, "recheck": rck, "refused": refused,
        "path_shapes": sorted(window.shapes), "profile_decode": prof,
        "max_memory_allocated": peak, "phase_s": phase_s}


# -------------------------------------------------------------- mamba path
def _to_float32(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_float32(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float32(torch, v) for v in tree]
    return tree.float()


def scan_vs_decode(torch, model, params, ctx, toks, tol, label):
    """MAMBA_PREFILL tokens of ``toks`` (B, 2 MAMBA_PREFILL) prefilled (one
    SSD chunk) and MAMBA_DECODE teacher-forced decode steps, against the
    chunked forward over all of ``toks``: the logits at the same positions
    within ``tol`` relative L2, each greedy token of the decode equal to
    the forward's or a near-tie there (``_tie_agreement``). Returns the
    readings and the two sets of logits (T + 1, B, V)."""
    P, T = MAMBA_PREFILL, MAMBA_DECODE
    with torch.no_grad():
        full = model.logits(params, model.backbone(params, toks, ctx))
        full = full[:, P - 1:P + T].float().transpose(0, 1)  # (T + 1, B, V)
        step = uniform_forced(torch, model, params, ctx, toks[:, :P],
                              toks[:, P:P + T + 1])
    torch.cuda.synchronize()
    rows = [_tie_agreement(torch, step[:, b], full[:, b], step[:, b].argmax(1))
            for b in range(toks.shape[0])]
    res = {"rel_l2": ((step - full).norm() / full.norm()).item(),
           "greedy_agree": sum(r["greedy_agree"] for r in rows),
           "n_tokens": sum(r["n_tokens"] for r in rows),
           "ties_ok": all(r["ties_ok"] for r in rows), "tolerance": tol}
    log(f"mamba2 prefill {P} + {T} decode steps against the chunked forward "
        f"over {2 * P} tokens (batch {toks.shape[0]}, {label}): logits "
        f"relative L2 diff "
        f"{res['rel_l2']:.4e} (tolerance {tol:g}), greedy tokens "
        f"{res['greedy_agree']}/{res['n_tokens']} equal, the others "
        f"near-ties: {res['ties_ok']}")
    if not math.isfinite(res["rel_l2"]) or res["rel_l2"] > tol or \
            not res["ties_ok"]:
        fail("mamba2: the recurrent decode disagrees with the chunked scan")
    return res, full, step


def mamba_phase(torch, np, rows):
    """mamba2-130m at full width and depth (24 layers, d_model 768, d_inner
    1536 in 24 heads of 64, SSM state 128, conv 4, vocab 50280, chunk 256;
    in_proj (768, 3352)), bf16, through the launcher: the trained phase's
    command for it (``launcher_argv``: W4 body, W8 layers 0 and 23, A8,
    QDrop, TRAIN_ITERS iterations, 64 x 64 tokens) with ``--serve-smoke
    --serve``, run by ``preempt_and_resume`` (uninterrupted in process; a
    subprocess SIGKILLed after block MAMBA_PREEMPT_AT's checkpoint, resumed
    in process: bit for bit). The uninterrupted run is the main path: the
    counters are zeroed just before it and read just after, K1 and K2 in
    both regimes and K3 must launch, and every shape it gave them is held
    against the plain versions (``check_path_shapes``). The error sum must
    fall, ``--serve`` must print the skip line (``unsupported_family:ssm``).
    Then ``scan_vs_decode`` in float32 on the fp weights (relative L2
    1e-3) and in bf16 on the export, with the kernels and with the plain
    versions (both within MAMBA_SCAN_TOL: the chunked path rounds the
    conv's products to bf16, the recurrent one sums them in float32), and
    each of its two paths with the kernels against the plain versions
    (5e-2); serve-smoke's prompt decoded greedily and re-run plain; the
    int8 cache refused (``kv_quant_unsupported:ssm``)."""
    from repro_torch.core.context import QuantCtx
    from repro_torch.serve import kv as skv

    t_phase = time.perf_counter()
    argv = launcher_argv(TRAIN_ITERS, "mamba2-130m", MAMBA_LAST) + [
        "--serve-smoke", "--serve"]
    log("mamba2: python -m repro_torch.launch.quantize " + " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    window = PathWindow(torch)  # the uninterrupted run: the main path's
    try:
        sys.stdout = tee
        pre = preempt_and_resume(torch, argv, MAMBA_PREEMPT_AT, "mamba",
                                 window)
    finally:
        sys.stdout = tee.out
    counts = window.counts
    rows.extend(check_path_shapes(torch, window, rows, "mamba2-130m"))
    run = pre.pop("result")
    cfg, qparams = run.cfg, run.qparams
    errs = pre["err"]
    before, after = sum(a for a, _ in errs), sum(b for _, b in errs)
    steps = sum(r.iters for r in run.reports)
    loop_s = sum(r.iters / r.steps_per_s for r in run.reports)
    skip = f"serve: skipped arch={cfg.name} reason=unsupported_family:ssm"
    got_w8 = sorted(i for i, layer in enumerate(qparams["layers"])
                    if any(qt.bits == 8 for qt in _qtensors(layer)))
    log(f"mamba2: {len(errs)} blocks, {steps} steps in {loop_s:.2f}s of Adam "
        f"loops ({steps / loop_s:.1f} steps/s); uninterrupted launcher "
        f"{pre['seconds']['uninterrupted']:.2f}s; serve-smoke "
        f"{run.serve_smoke_us:.1f} us/step; launches {counts}")
    log("mamba2 err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"mamba2: sum of err_before {before:.6e}, sum of err_after "
        f"{after:.6e}; skip line printed: {skip in tee.text()}")
    if (cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.vocab) != (
            24, 768, 128, 50280) or got_w8 != [0, MAMBA_LAST] or \
            not after < before or run.serve is not None or \
            skip not in tee.text() or not math.isfinite(run.serve_smoke_us):
        fail(f"mamba2 launcher: W8 layers {got_w8}, errors {before} -> "
             f"{after}, serve {run.serve}, skip line "
             f"{skip in tee.text()}")
    if counts["qmatmul_int8"] == 0:
        fail(f"the mamba2 path did not launch K3: {counts}")
    require_regimes(counts, "the mamba2 path")

    ctx = QuantCtx(mode="deploy", recipe=run.recipe, astates=run.astates)
    model = run.model
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 2 * MAMBA_PREFILL)), device=DEV)
    # the scan against the recurrence in float32 on the launcher's fp
    # weights (seed 0), then in bf16 on its export through the kernels
    fparams = _to_float32(torch, model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    plain = QuantCtx(mode="deploy", recipe=run.recipe, astates=run.astates,
                     backend="torch")
    scan, logits = {}, {}
    for kind, p, c, tol in (
            ("float32", fparams, QuantCtx(mode="fp"), 1e-3),
            ("bf16", qparams, ctx, MAMBA_SCAN_TOL),
            ("bf16_plain", qparams, plain, MAMBA_SCAN_TOL)):
        scan[kind], *logits[kind] = scan_vs_decode(
            torch, model, p, c, toks, tol,
            {"float32": "float32 fp weights", "bf16": "bf16 export, kernels",
             "bf16_plain": "bf16 export, plain versions"}[kind])
    # each regime's kernels against the plain versions on the same path:
    # the chunked forward (mma) and the recurrent decode (decode regime);
    # the bf16 limit of every plain re-run (on an H100 3.2e-2 and 3.0e-2,
    # as serve-smoke's re-run)
    for i, path in enumerate(("chunked", "decode")):
        k, t = logits["bf16"][i], logits["bf16_plain"][i]
        scan[f"kernels_vs_plain_{path}"] = rel = (
            (k - t).norm() / t.norm()).item()
        log(f"mamba2 {path} logits, kernels against plain versions: "
            f"relative L2 {rel:.4e} (tolerance 5e-2)")
        if not math.isfinite(rel) or rel > 5e-2:
            fail(f"mamba2: the {path} path's kernels disagree with their "
                 "plain versions beyond bf16 tolerance")
    del fparams, logits

    # serve-smoke's prompt: greedy with the kernels, then the plain versions
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(
        ).manual_seed(0)).to(DEV)
    res = {}
    with torch.no_grad():
        gen_toks, res["auto"], _ = uniform_greedy(torch, model, qparams, ctx,
                                                  prompt, 8)
        res["torch"] = uniform_forced(torch, model, qparams, plain, prompt,
                                      gen_toks)
    rck = _tie_agreement(torch, res["auto"][:, 0], res["torch"][:, 0],
                         gen_toks[0])
    log(f"mamba2: torch backend re-run of serve-smoke's request 0: logits "
        f"relative L2 diff {rck['rel_l2']:.4e} (tolerance 5e-2), max |diff| "
        f"{rck['max_abs_diff']:.4e}; greedy tokens {rck['greedy_agree']}/"
        f"{rck['n_tokens']} identical, the others near-ties: "
        f"{rck['ties_ok']}")
    if not math.isfinite(rck["rel_l2"]) or rck["rel_l2"] > 5e-2 or \
            not rck["ties_ok"]:
        fail("mamba2: kernel and plain-version serving disagree beyond bf16 "
             "tolerance")
    try:
        model.init_cache(2, 8, kv_quant=True)
        refused = None
    except skv.KVQuantUnsupported as e:
        refused = e.reason
    prof = profile_uniform(torch, model, qparams, ctx, prompt, "mamba2")
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"mamba2: init_cache(kv_quant=True) refused with {refused}; "
        f"max_memory_allocated {peak} B; phase {phase_s:.1f}s")
    if refused != "kv_quant_unsupported:ssm":
        fail(f"mamba2: the int8 cache answered {refused}")
    return counts, dict(
        pre, argv=argv, steps=steps, loop_s=loop_s,
        steps_per_s=steps / loop_s, err_before_sum=before,
        err_after_sum=after, serve_smoke_us=run.serve_smoke_us,
        scan_vs_decode=scan, path_shapes=sorted(window.shapes),
        profile_decode=prof,
        recheck=rck, refused=refused, max_memory_allocated=peak,
        phase_s=phase_s)


# ------------------------------------------------------------- hybrid path
def forward_vs_decode(torch, model, params, ctx, prompt, generated, tol,
                      label):
    """``prompt`` (B, P) prefilled and ``generated`` (B, T + 1) fed along
    by T decode steps (``uniform_forced``), against the teacher-forced
    full forward (``backbone``) over the P + T tokens: the logits at the
    same positions within ``tol`` relative L2, each decode step's greedy
    token the forward's or a near-tie (``_tie_agreement``). Returns the
    readings and the decode's logits (T + 1, B, V) in float32."""
    P, T = prompt.shape[1], generated.shape[1] - 1
    with torch.no_grad():
        toks = torch.cat([prompt, generated[:, :T]], dim=1)
        x, _ = model.backbone(params, toks, ctx)
        full = model.logits(params, x[:, P - 1:]).float().transpose(0, 1)
        del x
        step = uniform_forced(torch, model, params, ctx, prompt, generated)
    torch.cuda.synchronize()
    rows = [_tie_agreement(torch, step[:, b], full[:, b], step[:, b].argmax(1))
            for b in range(prompt.shape[0])]
    res = {"rel_l2": ((step - full).norm() / full.norm()).item(),
           "greedy_agree": sum(r["greedy_agree"] for r in rows),
           "n_tokens": sum(r["n_tokens"] for r in rows),
           "ties_ok": all(r["ties_ok"] for r in rows), "tolerance": tol}
    log(f"recurrentgemma prefill {P} + {T} decode steps against the full "
        f"forward over {P + T} tokens (batch {prompt.shape[0]}, {label}): "
        f"logits relative L2 diff {res['rel_l2']:.4e} (tolerance {tol:g}), "
        f"greedy tokens {res['greedy_agree']}/{res['n_tokens']} equal, the "
        f"others near-ties: {res['ties_ok']}")
    if not math.isfinite(res["rel_l2"]) or res["rel_l2"] > tol or \
            not res["ties_ok"]:
        fail(f"recurrentgemma: the decode ({label}) disagrees with the full "
             "forward")
    return res, step


def hybrid_phase(torch, np, rows):
    """recurrentgemma-2b at full width with RG_LAYERS of its 26 layers
    (three whole RRA groups: 6 RG-LRU and 3 local-attention blocks, d_model
    = lru_width 2560, 10 query heads and 1 KV head of 256, geglu d_ff 7680,
    vocab 256000, window 2048), weights from torch.Generator seed 0.
    First blocks 1 (R) and 2 (A) of the launcher's recipe, RG_GRAPH_ITERS
    iterations graphed against graphs=False, bit for bit (two engines).
    Then the main path, the counters zeroed just before and read just
    after: the launcher in process with the trained phase's command
    (``launcher_argv``: W4 body, W8 layers 0 and RG_LAST, A8, QDrop,
    TRAIN_ITERS iterations, 64 x 64 tokens) and ``--serve-smoke --serve``:
    three engines (R at W8, R at W4, A at W4) and their captures, the
    error sum must fall, ``--serve`` must print its skip line
    (``unsupported_family:hybrid``); K1 in both regimes and K3 must
    launch (its sites carry their layer index, so the activation states
    apply: the W8 layers serve as W8A8 through K3, the body as W4A8 through
    K1), and every shape the run gave K1-K3 is held against the plain
    versions (``check_path_shapes``). Then greedy decodes over the export
    (batch 2, RG_PROMPT prefilled tokens, RG_DECODE steps: the ring of 2048
    slots wraps), as exported and without the activation states, each
    against the full forward (``forward_vs_decode``) and re-run along its
    tokens with the plain versions (RG_A8_TOL; RG_DECODE_TOL and 5e-2),
    the same in float32 on the fp weights (1e-3); the int8 cache refused;
    8 decode steps traced."""
    from repro_torch.configs import get_config
    from repro_torch.core import reconstruct as rc
    from repro_torch.core.context import QuantCtx
    from repro_torch.data import CalibrationSet, SyntheticTokens
    from repro_torch.launch import quantize as launcher
    from repro_torch.models.model import build_model
    from repro_torch.serve import kv as skv

    t_phase = time.perf_counter()
    argv = launcher_argv(TRAIN_ITERS, "recurrentgemma-2b", RG_LAST) + [
        "--serve-smoke", "--serve"]
    args = launcher.build_parser().parse_args(argv)
    recipe = launcher.build_recipe(args)
    # one RRA period at full width: init draws the layers first, so these
    # are the launcher's first three layers
    cfg3 = dataclasses.replace(get_config(args.arch), n_layers=3)
    model3 = build_model(cfg3)
    params3 = model3.init(torch.Generator(device=DEV).manual_seed(0),
                          device=DEV)
    src = SyntheticTokens(vocab=cfg3.vocab, seq_len=args.seq, seed=0)
    calib = torch.as_tensor(CalibrationSet.build(src, args.calib).tokens,
                            device=DEV)
    x0, blocks, _ = model3.quant_blocks(params3, calib)
    recon12, errs12 = recon_graphs_equal(
        torch, np, blocks[1:3], dataclasses.replace(recipe,
                                                    iters=RG_GRAPH_ITERS),
        x0, 2, "recurrentgemma blocks 1 (R) and 2 (A)")
    del params3, x0, blocks
    gc.collect()
    torch.cuda.empty_cache()

    log("recurrentgemma: python -m repro_torch.launch.quantize "
        + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    window = PathWindow(torch)
    real_get_config = launcher.get_config
    launcher.get_config = lambda name: dataclasses.replace(
        real_get_config(name), n_layers=RG_LAYERS)
    try:
        sys.stdout = tee
        window.start()  # the recurrentgemma main path's run starts here
        t0 = time.perf_counter()
        run = launcher.main(argv + ["--out", str(RUNS_DIR / "rg_export")])
        counts = window.stop()  # ... and ends here
        launcher_s = time.perf_counter() - t0
    finally:
        sys.stdout = tee.out
        launcher.get_config = real_get_config
    rows.extend(check_path_shapes(torch, window, rows, "recurrentgemma-2b"))
    cfg, model, qparams = run.cfg, run.model, run.qparams
    errs = [(r.err_before, r.err_after) for r in run.reports]
    before, after = sum(a for a, _ in errs), sum(b for _, b in errs)
    steps = sum(r.iters for r in run.reports)
    loop_s = sum(r.iters / r.steps_per_s for r in run.reports)
    st = rc.engine_stats()
    skip = f"serve: skipped arch={cfg.name} reason=unsupported_family:hybrid"
    got_w8 = sorted(i for i, layer in enumerate(qparams["layers"])
                    if any(qt.bits == 8 for qt in _qtensors(layer)))
    by_kind = {k: [r.steps_per_s for r, kind in zip(run.reports, model.kinds)
                   if kind == k] for k in "RA"}
    log(f"recurrentgemma: {len(errs)} blocks, {steps} steps in {loop_s:.2f}s "
        f"of Adam loops ({steps / loop_s:.1f} steps/s; R blocks "
        f"{np.mean(by_kind['R']):.1f}, A blocks {np.mean(by_kind['A']):.1f} "
        f"steps/s); launcher {launcher_s:.2f}s; engines {st.engine_builds} "
        f"built, {st.step_compiles} step captures; serve-smoke "
        f"{run.serve_smoke_us:.1f} us/step; launches {counts}")
    log("recurrentgemma err_before/err_after per block: "
        + " ".join(f"{a:.4e}/{b:.4e}" for a, b in errs))
    log(f"recurrentgemma: sum of err_before {before:.6e}, sum of err_after "
        f"{after:.6e}; skip line printed: {skip in tee.text()}")
    if (cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.head_dim, cfg.vocab,
            cfg.local_window) != (RG_LAYERS, 2560, 2560, 256, 256000,
                                  2048) or \
            got_w8 != [0, RG_LAST] or not after < before or \
            run.serve is not None or skip not in tee.text() or \
            not math.isfinite(run.serve_smoke_us) or \
            {r.engine for r in run.reports} != {"graph"} or \
            st.engine_builds != 3 or st.step_compiles != 3:
        fail(f"recurrentgemma launcher: W8 layers {got_w8}, errors {before} "
             f"-> {after}, serve {run.serve}, skip line "
             f"{skip in tee.text()}, {st}")
    if counts["qmatmul_int8"] == 0 or any(
            counts[f"dequant_matmul_w4[{r}]"] == 0 for r in ("decode", "mma")):
        fail(f"the recurrentgemma path did not launch K1 in both regimes "
             f"and K3: {counts}")

    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, RG_PROMPT)), device=DEV)
    ring = min(cfg.local_window, RG_PROMPT + RG_DECODE + 1)
    if not RG_PROMPT < ring < RG_PROMPT + RG_DECODE:
        fail(f"recurrentgemma: a ring of {ring} slots does not wrap")
    checks, rechecks, greedy = {}, {}, {}
    # as exported (W4A8, W8A8), then without the activation states
    for tag, astates, tol in (("w4a8", run.astates, RG_A8_TOL),
                              ("weights_only", {}, RG_DECODE_TOL)):
        c = QuantCtx(mode="deploy", recipe=run.recipe, astates=astates)
        t0 = time.perf_counter()
        with torch.no_grad():
            gen_toks, glogits, gstats = uniform_greedy(torch, model, qparams,
                                                       c, prompt, RG_DECODE)
        greedy[tag] = dict(gstats, seconds=time.perf_counter() - t0)
        checks[tag], dec = forward_vs_decode(
            torch, model, qparams, c, prompt, gen_toks, tol,
            f"bf16 export, {tag}, kernels")
        with torch.no_grad():
            dec_plain = uniform_forced(
                torch, model, qparams, QuantCtx(
                    mode="deploy", recipe=run.recipe, astates=astates,
                    backend="torch"), prompt, gen_toks)
        rck = rechecks[tag] = _tie_agreement(
            torch, dec.transpose(0, 1), dec_plain.transpose(0, 1), gen_toks)
        ptol = tol if tag == "w4a8" else 5e-2
        log(f"recurrentgemma greedy decode [{tag}, batch 2, {RG_PROMPT} + "
            f"{RG_DECODE}]: {gstats['us_per_step']:.1f} us/step "
            f"({greedy[tag]['seconds']:.2f}s with the prefill); forced along "
            f"its tokens it equals the greedy logits: "
            f"{bool(torch.equal(dec, glogits))}; plain versions: logits "
            f"relative L2 diff {rck['rel_l2']:.4e} (tolerance {ptol:g}), "
            f"greedy tokens {rck['greedy_agree']}/{rck['n_tokens']}, the "
            f"others near-ties: {rck['ties_ok']}")
        if not math.isfinite(rck["rel_l2"]) or rck["rel_l2"] > ptol or \
                not rck["ties_ok"]:
            fail(f"recurrentgemma: kernel and plain-version decode ({tag}) "
                 "disagree beyond their tolerance")
        del dec, dec_plain, glogits
    ctx = QuantCtx(mode="deploy", recipe=run.recipe, astates=run.astates)
    # float32 throughout (the ring too): the launcher's fp weights widened
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    fparams = _to_float32(torch, model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    with torch.no_grad():
        ftoks, _, _ = uniform_greedy(torch, model32, fparams,
                                     QuantCtx(mode="fp"), prompt, RG_DECODE)
    checks["float32"], _ = forward_vs_decode(
        torch, model32, fparams, QuantCtx(mode="fp"), prompt, ftoks, 1e-3,
        "float32 fp weights")
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    try:
        model.init_cache(2, 8, kv_quant=True)
        refused = None
    except skv.KVQuantUnsupported as e:
        refused = e.reason
    prof = profile_uniform(torch, model, qparams, ctx, prompt[:, :16],
                           "recurrentgemma")
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"recurrentgemma: init_cache(kv_quant=True) refused with {refused}; "
        f"max_memory_allocated {peak} B; phase {phase_s:.1f}s")
    if refused != "kv_quant_unsupported:hybrid":
        fail(f"recurrentgemma: the int8 cache answered {refused}")
    return counts, dict(
        argv=argv, recon_blocks_1_2=dict(recon12, errors=errs12),
        launcher_s=launcher_s, steps=steps, loop_s=loop_s,
        steps_per_s=steps / loop_s,
        steps_per_s_by_kind={k: float(np.mean(v)) for k, v in by_kind.items()},
        engine_stats=dataclasses.asdict(st), err=errs, err_before_sum=before,
        err_after_sum=after, serve_smoke_us=run.serve_smoke_us,
        greedy=greedy, decode_vs_forward=checks, recheck=rechecks,
        refused=refused, path_shapes=sorted(window.shapes),
        profile_decode=prof, max_memory_allocated=peak, phase_s=phase_s)


# ---------------------------------------------------------------- training
def _state_diff(torch, a, b):
    """(leaves that differ, the largest |a - b| over them) of two training
    states: tensors compared bit for bit, other leaves by value."""
    from repro_torch.optim.adam import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return len(la) + len(lb), float("inf")
    n, worst = 0, 0.0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if x.dtype == y.dtype and x.shape == y.shape and torch.equal(
                    x.reshape(-1).view(torch.uint8),
                    y.reshape(-1).view(torch.uint8)):
                continue
            n += 1
            worst = max(worst, (x.float() - y.float()).abs().max().item())
        elif x != y:
            n, worst = n + 1, float("inf")
    return n, worst


def _train_steps(torch, model, cfg, opt, state, batches, microbatch=1):
    """``make_train_step`` over ``batches``: (state, losses, gnorms, ms per
    step from CUDA events on the card)."""
    from repro_torch.launch import steps
    step = steps.make_train_step(model, cfg, opt, microbatch)
    losses, gnorms, ms = [], [], []
    for batch in batches:
        on_card = next(iter(batch.values())).is_cuda
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, m = step(state, batch)
        if on_card:
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return state, losses, gnorms, ms


def train_phase(torch, np):
    """Training on the card (``launch.steps.make_train_step``: the fp
    forward, its autograd gradient, AdamW with weight decay and clipping,
    the optimizer of the arch's ``ARCH_MODE``), every run with cfg.remat on:
    smollm-135m at full width and depth (batch 8 x 1024 tokens, 10 steps)
    and recurrentgemma-2b at full width with 3 layers (one RRA period;
    batch 4 x 2048, 5 steps), SyntheticTokens batches; each reports loss,
    gnorm, ms per step (CUDA events) and max_memory_allocated, and must
    take its steps with finite losses and norms (5-10 steps at the
    reference's lr 3e-4 move the loss by less than its step-to-step
    spread). Then the reduced float32 configs of both (TRAIN_CHECK_ARCHS):
    3 steps on the card from the CPU's init and batches against the same 3
    steps on the CPU (loss and gnorm within relative 1e-4; parameters within
    1e-6 but at most 0.5% of a leaf's elements, none beyond 3 lr: Adam's
    first steps follow the rounding of gradients near eps), and
    ``microbatch=2`` against ``microbatch=1`` on the card (the same
    tolerances). Last, ``python -m repro_torch.launch.train --arch
    recurrentgemma-2b --smoke --steps 20 --ckpt-every 10`` in a subprocess,
    SIGKILLed once it prints its step-10 checkpoint, then resumed in
    process: its final state must equal an unbroken run's bit for bit."""
    import os
    import signal
    import threading

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as trainer
    from repro_torch.launch import sharding, steps
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import adam_init, tree_leaves

    out = {"runs": {}, "card_vs_cpu": {}}
    for arch, layers, B, S, n in TRAIN_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEV).manual_seed(0),
                            device=DEV)
        opt = steps.TRAIN_OPT[sharding.ARCH_MODE[arch]]
        state = {"params": params, "opt": adam_init(params, opt), "step": 0}
        del params
        src = SyntheticTokens(vocab=cfg.vocab, seq_len=S, seed=0)
        batches = [trainer.make_batch(cfg, src, i, B, S, DEV)
                   for i in range(n)]
        state, losses, gnorms, ms = _train_steps(torch, model, cfg, opt,
                                                 state, batches)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        tok_s = B * S / (np.median(ms) / 1e3)
        log(f"train [{arch}, {cfg.n_layers} layers, {n_params} params, "
            f"remat {cfg.remat}, batch {B} x {S}]: loss "
            + " ".join(f"{v:.4f}" for v in losses) + "; gnorm "
            + " ".join(f"{v:.3f}" for v in gnorms) + "; ms per step "
            + " ".join(f"{v:.1f}" for v in ms)
            + f" (median {np.median(ms):.1f}, {tok_s:.0f} tokens/s); "
            f"max_memory_allocated {peak} B")
        if not cfg.remat or not all(map(math.isfinite, losses + gnorms)) \
                or state["step"] != n or state["opt"]["count"] != n:
            fail(f"train [{arch}]: loss {losses}, gnorm {gnorms}, step "
                 f"{state['step']}")
        out["runs"][arch] = dict(layers=cfg.n_layers, batch=B, seq=S,
                                 n_params=n_params, loss=losses, gnorm=gnorms,
                                 ms=ms, tokens_per_s=tok_s,
                                 max_memory_allocated=peak)
        del state, batches
    gc.collect()
    torch.cuda.empty_cache()

    lr = steps.TRAIN_OPT["dp"].lr
    for arch in TRAIN_CHECK_ARCHS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        src = SyntheticTokens(vocab=cfg.vocab, seq_len=64, seed=0)
        cpu_batches = [trainer.make_batch(cfg, src, i, 8, 64, "cpu")
                       for i in range(3)]
        opt = steps.TRAIN_OPT[sharding.ARCH_MODE[arch]]
        res = {}
        for tag, dev, mb in (("cpu", "cpu", 1), ("card", DEV, 1),
                             ("card_mb2", DEV, 2)):
            p = _to_device(torch, params, dev)
            state = {"params": p, "opt": adam_init(p, opt), "step": 0}
            batches = [{k: v.to(dev) for k, v in b.items()}
                       for b in cpu_batches]
            state, losses, gnorms, _ = _train_steps(torch, model, cfg, opt,
                                                    state, batches, mb)
            res[tag] = (tree_leaves(_to_device(torch, state["params"], "cpu")),
                        losses, gnorms)
        readings = {}
        for tag in ("card", "card_mb2"):
            leaves, losses, gnorms = res[tag]
            ref_leaves, ref_losses, ref_gnorms = res["cpu"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                losses + gnorms, ref_losses + ref_gnorms))
            worst, over = 0.0, []
            for x, y in zip(leaves, ref_leaves):
                d = (x.double() - y.double()).abs()
                worst = max(worst, d.max().item())
                over.append(((d > 1e-6).sum().item(), d.numel()))
            allowed = all(k <= max(1, n // 200) for k, n in over)
            readings[tag] = {"rel_loss_gnorm": rel, "max_param_diff": worst,
                             "beyond_1e-6": max(over)}
            log(f"train [{cfg.name}, float32, 3 steps] {tag} against the "
                f"CPU: loss and gnorm relative {rel:.3e} (1e-4), parameters "
                f"max |diff| {worst:.3e} (3 lr = {3 * lr:g}), elements "
                f"beyond 1e-6 (of their leaf) "
                + " ".join(f"{k}/{n}" for k, n in over if k)
                + " (at most 0.5% of a leaf, one in a leaf under 200)")
            if not rel <= 1e-4 or not worst <= 3 * lr or not allowed:
                fail(f"train [{cfg.name}]: the card ({tag}) disagrees with "
                     "the CPU")
        out["card_vs_cpu"][arch] = readings

    # the launcher killed after its step-10 checkpoint and resumed
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--steps",
            str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_KILL_AT)]
    ckpt_a, ckpt_b = RUNS_DIR / "train_a", RUNS_DIR / "train_b"
    for d in (ckpt_a, ckpt_b):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    unbroken = trainer.main(argv + ["--ckpt-dir", str(ckpt_a)])
    unbroken_s = time.perf_counter() - t0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv
        + ["--ckpt-dir", str(ckpt_b)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))
    timer = threading.Timer(300, child.kill)
    timer.start()
    killed, lines = False, []
    try:
        for line in child.stdout:
            lines.append(line)
            if line.startswith(f"checkpoint: step {TRAIN_KILL_AT} saved"):
                child.send_signal(signal.SIGKILL)
                killed = True
                break
    finally:
        timer.cancel()
        if child.poll() is None and not killed:
            child.kill()
        child.wait()
        child.stdout.close()
    child_s = time.perf_counter() - t0
    saved = CheckpointManager(str(ckpt_b)).all_steps()
    if not killed or child.returncode != -signal.SIGKILL or \
            saved != [TRAIN_KILL_AT]:
        fail(f"train launcher: the child was not killed after step "
             f"{TRAIN_KILL_AT} (exit {child.returncode}, checkpoints "
             f"{saved}):\n{''.join(lines)[-3000:]}")
    t0 = time.perf_counter()
    resumed = trainer.main(argv + ["--ckpt-dir", str(ckpt_b)])
    resumed_s = time.perf_counter() - t0
    n_diff, worst = _state_diff(torch, unbroken, resumed)
    log(f"train launcher [recurrentgemma-2b-smoke, {TRAIN_STEPS} steps]: "
        f"unbroken {unbroken_s:.2f}s; child killed after its step-"
        f"{TRAIN_KILL_AT} checkpoint ({child_s:.2f}s), resumed "
        f"{resumed_s:.2f}s; final states differ at {n_diff} leaves, largest "
        f"|diff| {worst:.3e}")
    if n_diff:
        fail("train launcher: the resumed run differs from the unbroken one")
    for d in (ckpt_a, ckpt_b):
        shutil.rmtree(d, ignore_errors=True)
    out["resume"] = dict(unbroken_s=unbroken_s, child_s=child_s,
                         resumed_s=resumed_s, leaves_differ=n_diff,
                         max_abs_diff=worst)
    return out


def _to_device(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(torch, v, dev) for v in tree]
    return tree.to(dev)


def plain_loss(torch, model, params, batch, ctx):
    """The loss without chunks: the same backbone, then the logits of every
    position at once in float32 and ``torch.nn.functional.cross_entropy``,
    with the prefix masked and the labels left-padded as ``model.loss``
    does; plus 0.01 x the aux loss, and 0.3 x the mtp head's cross entropy
    (computed the same way) when the config has one. Returns (total,
    {"ce", "aux"[, "mtp_ce"]}) as ``model.loss`` does."""
    F = torch.nn.functional
    cfg = model.cfg
    pe = batch.get("patch_embeds")
    x, aux, _ = model.backbone(params, batch["tokens"], ctx, pe)
    labels = batch["labels"]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=DEV)
    if pe is not None:
        P = pe.shape[1]
        labels = F.pad(labels, (P, 0))
        mask = F.pad(mask, (P, 0))
    logits = (x.float() @ model.lm_head(params).float()) * cfg.logit_mult
    ce = F.cross_entropy(logits.reshape(-1, cfg.vocab), labels.reshape(-1),
                         reduction="none")
    ce = (ce * mask.reshape(-1)).sum() / mask.sum().clamp(min=1.0)
    total, m = ce + 0.01 * aux, {"ce": ce, "aux": aux}
    if cfg.mtp:
        from repro_torch.models import common
        from repro_torch.models.transformer import MTP_WEIGHT
        head = params["mtp"]
        emb = common.embed_tokens(params["embed"], batch["tokens"],
                                  cfg.emb_mult)
        z = ctx.linear("mtp.proj", torch.cat([x[:, :-1], emb[:, 1:]], -1),
                       head["proj"])
        z = common.rmsnorm(z, head["norm"]["scale"])
        B, S, _ = z.shape
        sin, cos = model._rope(torch.arange(S, device=DEV)[None].expand(B, S))
        z = model.layer_apply(head["layer"], z, ctx, "mtp.layer", sin, cos)[0]
        zl = (z.float() @ model.lm_head(params).float()) * cfg.logit_mult
        m["mtp_ce"] = F.cross_entropy(zl.reshape(-1, cfg.vocab),
                                      batch["labels"][:, 1:].reshape(-1))
        total = total + MTP_WEIGHT * m["mtp_ce"]
    return total, m


def loss_phase(torch, np):
    """``model.loss`` (the chunked cross entropy, each chunk recomputed in
    the backward) against ``plain_loss`` on the same weights and inputs, at
    full width in float32 (no TF32): olmo-1b with 2 layers, B = 2, S = 1000
    (two chunks of 512, the second padded and masked), and
    phi-3-vision-4.2b with 2 of its 32 layers and 256 random patch
    embeddings in front of 256 tokens (512 positions: one chunk). Compared:
    the loss (relative 1e-5) and the gradients of the embedding, the head
    and layer 1's wq and w_down (largest |difference| at most 1e-4 of the
    largest |gradient| of each; both sides sum float32 products in other
    orders, ~1e-6, where a wrong chunk or mask is off by 1e-2 or more), and
    max_memory_allocated of each run from the same start: the chunked run
    must peak below the unchunked one (at one chunk too: it keeps no
    logits from its forward, and ``cross_entropy`` keeps its
    log-softmax)."""
    from repro_torch.configs import get_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.models.model import build_model
    out = []
    for arch, n_layers, B, S, P in LOSS_RUNS:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  dtype="float32")
        model = build_model(cfg)
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = model.init(gen)
        rng = np.random.default_rng(1)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                    device=DEV) for k in ("tokens", "labels")}
        if P:
            batch["patch_embeds"] = torch.randn((B, P, cfg.d_model),
                                                generator=gen, device=DEV)
        watched = {"embed": params["embed"], "lm_head": params["lm_head"],
                   "layers.1.attn.wq": params["layers"][1]["attn"]["wq"],
                   "layers.1.mlp.w_down": params["layers"][1]["mlp"]["w_down"]}
        leaves = [params["embed"], params["lm_head"]] + [
            t for layer in params["layers"] for grp in layer.values()
            for t in grp.values()]
        for t in leaves:
            t.requires_grad_(True)
        ctx = QuantCtx(mode="fp")
        runs = {}
        for tag, fn in (("chunked", lambda: model.loss(params, batch, ctx)[0]),
                        ("plain", lambda: plain_loss(torch, model, params,
                                                     batch, ctx)[0])):
            for t in leaves:
                t.grad = None
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = fn()
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            grads = {k: v.grad.detach().clone() for k, v in watched.items()}
            runs[tag] = (loss.item(), grads, peak, seconds)
            del loss
        (lc, g_c, pc, sc), (lp, g_p, pp, sp) = runs["chunked"], runs["plain"]
        rel = abs(lc - lp) / abs(lp)
        gdiff = {k: ((g_c[k] - g_p[k]).abs().max() / g_p[k].abs().max()).item()
                 for k in watched}
        n_chunks = -(-(S + P) // cfg.xent_chunk)
        log(f"loss [{arch}, {n_layers} layers, B={B}, S={S}, P={P}, vocab "
            f"{cfg.vocab}, {n_chunks} chunk(s) of {cfg.xent_chunk}]: chunked "
            f"{lc:.6f} in {sc:.3f}s, plain {lp:.6f} in {sp:.3f}s, relative "
            f"difference {rel:.3e} (tolerance 1e-5); largest gradient "
            f"difference over the largest gradient: " + ", ".join(
                f"{k} {v:.3e}" for k, v in gdiff.items())
            + f" (tolerance 1e-4); max_memory_allocated chunked {pc} B, "
            f"plain {pp} B")
        if not (math.isfinite(lc) and rel <= 1e-5
                and all(v <= 1e-4 for v in gdiff.values())):
            fail(f"loss [{arch}]: the chunked loss or its gradients disagree "
                 "with the plain cross entropy")
        if not pc < pp:
            fail(f"loss [{arch}]: the chunked run peaked at {pc} B, not below "
                 f"the unchunked run's {pp} B")
        out.append({"arch": arch, "layers": n_layers, "B": B, "S": S, "P": P,
                    "chunks": n_chunks, "loss": lc, "plain_loss": lp,
                    "rel_diff": rel, "grad_rel_diff": gdiff,
                    "peak_chunked": pc, "peak_plain": pp,
                    "seconds_chunked": sc, "seconds_plain": sp})
        del params, leaves, watched, runs, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- mesh
MESH_ITERS = 12  # the reference's exact horizon (tests/test_sharded_recon.py)
MESH_RANKS = 8   # the debug mesh (2, 4): 2 data-parallel ranks x 4 model
# (a) and (b) take 3 of smollm-135m's 30 layers (W8 layers 0 and 2): full
# width, so every kernel shape, engine and collective of the full depth, a
# tenth of its blocks (they ran all 30 until the cells phase needed the
# seconds, 6 until the dry-run phase did)
MESH_LAYERS = 3
MESH_BACKEND = "nccl"  # the in-process group of one rank
# The 8 ranks against one process (PERF.md §6). Float summation
# order differs, and Adam's first steps turn a near-zero gradient's sign
# into a whole step of lr: a rounding choice flips by one level, a W8
# channel's scale (lr 3e-3 against scales of ~1e-3) moves its codes by
# many (block 0's loss jumps from ~1e-3 to ~0.4 at its first step on
# either side), and block 0 (W8) passes its export's differences on to
# every later block's input. Only block 0's first loss (its inputs, states
# and masks the same on both sides, before any update) is comparable
# tightly. Measured on the CPU with this recipe (the smoke model through
# the launcher, 8 ranks; a 6-layer smoke model, 2 ranks, 3 seeds): block 0's
# first loss within 1e-7, its second within 1.5e-2, block errors within a
# factor 1.47, error sums within 28.5%. The codes follow the states: up to
# 94% of a W8 site's bytes and, at full size on the card, 42% of a W4
# site's bytes differ by more than one level (PERF.md §6), so the
# export is held by its errors, its sites' layout and its zero points (the
# observer's grid from the same weights), which must be equal.
MESH_FIRST_TOL = 1e-5    # relative, block 0's first loss
MESH_FACTOR = 2.0        # each block's err_after within this factor
MESH_SUM_TOL = 0.5       # relative, the sum of err_after


def mesh_argv():
    """The mesh phase's launcher flags (the launcher's smollm recipe at
    MESH_LAYERS layers)."""
    return launcher_argv(MESH_ITERS, last=MESH_LAYERS - 1) + [
        "--serve-smoke", "--serve"]


@contextlib.contextmanager
def mesh_depth():
    """The launcher's configs cut to MESH_LAYERS layers inside the block."""
    from repro_torch.launch import quantize as launcher
    real = launcher.get_config
    launcher.get_config = lambda name: dataclasses.replace(
        real(name), n_layers=MESH_LAYERS)
    try:
        yield
    finally:
        launcher.get_config = real


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _count_collectives(torch, counts):
    """Wrap ``DataParallel.all_reduce`` and ``assemble`` to count the calls
    and those made while a CUDA graph captures; returns the undo."""
    from repro_torch.launch import mesh as meshes
    real = {n: getattr(meshes.DataParallel, n) for n in ("all_reduce",
                                                          "assemble")}

    def wrap(name, fn):
        def counted(self, *args, **kwargs):
            counts["calls"] += 1
            if torch.cuda.is_current_stream_capturing():
                counts["captured"] += 1
            return fn(self, *args, **kwargs)
        return counted

    for n, fn in real.items():
        setattr(meshes.DataParallel, n, wrap(n, fn))

    def undo():
        for n, fn in real.items():
            setattr(meshes.DataParallel, n, fn)
    return undo


def mesh_world1_check(torch, np):
    """(a) of the mesh phase: an NCCL group of one rank in process."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import reconstruct as rc
    from repro_torch.core.context import QuantCtx
    from repro_torch.data import CalibrationSet, SyntheticTokens
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import quantize as launcher
    from repro_torch.models.model import build_model
    from repro_torch.obs import profiler
    from repro_torch.optim import adam, compress

    args = launcher.build_parser().parse_args(
        launcher_argv(MESH_ITERS, last=MESH_LAYERS - 1))
    recipe = launcher.build_recipe(args)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=MESH_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    calib = torch.as_tensor(CalibrationSet.build(SyntheticTokens(
        vocab=cfg.vocab, seq_len=args.seq, seed=0), args.calib).tokens).to(DEV)
    x0, blocks, _ = model.quant_blocks(params, calib)
    kwargs = ({"device_id": torch.device(DEV, 0)} if MESH_BACKEND == "nccl"
              else {})
    dist.init_process_group(MESH_BACKEND, init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1, **kwargs)
    out = {"backend": dist.get_backend()}
    try:
        mesh = meshes.make_flat_mesh(1, device_type=DEV)
        runs, coll = {}, {"calls": 0, "captured": 0}
        for tag, m in (("plain", None), ("mesh", mesh)):
            rc.reset_engine_stats()
            undo = _count_collectives(torch, coll) if m is not None else None
            t0 = time.perf_counter()
            try:
                runs[tag] = rc.quantize_blocks(blocks, recipe, x0, mesh=m)
                torch.cuda.synchronize()
            finally:
                if undo is not None:
                    undo()
            st = rc.engine_stats()
            out[tag] = {"seconds": time.perf_counter() - t0,
                        "engines": st.engine_builds,
                        "captures": st.step_compiles}
            reps = runs[tag][2]
            if (st.engine_builds, st.step_compiles) != (2, 2) or any(
                    r.engine != "graph" for r in reps):
                fail(f"mesh world 1 [{tag}]: {st}, engines "
                     f"{sorted({r.engine for r in reps})}")
        (fp, ap, rp), (fm, am, rm) = runs["plain"], runs["mesh"]
        diff = (_same_tree(torch, fp, fm, "finalized")
                + _same_tree(torch, ap, am, "astates"))
        errs = [(r.err_before, r.err_after) for r in rp]
        if [(r.err_before, r.err_after) for r in rm] != errs:
            diff.append("errors")
        step = _first_curve_diff(np, rp, rm)
        out.update(collectives=coll, tensors_differ=len(diff),
                   first_curve_diff=step, err=errs)
        log(f"mesh world 1 ({out['backend']}): smollm-135m, {len(blocks)} blocks x "
            f"{MESH_ITERS} steps graphed, mesh=make_flat_mesh(1) against "
            f"mesh=None: {len(diff)} tensors differ, first curve difference "
            f"{step}; plain {out['plain']['seconds']:.2f}s, mesh "
            f"{out['mesh']['seconds']:.2f}s; collectives issued {coll['calls']}"
            f", {coll['captured']} of them inside the 2 captured steps")
        if diff or step is not None:
            fail(f"mesh world 1: the mesh run differs from mesh=None: "
                 f"{diff[:10]}, first curve difference {step}")
        if coll["captured"] != 4:  # 2 engines x (assembly + gradients)
            fail(f"mesh world 1: the captured steps issued {coll['captured']} "
                 "collectives, not 2 each")

        # 20 replays of block 1's captured step under the mesh, traced
        with torch.no_grad():
            x1 = blocks[0].apply(blocks[0].params, x0, QuantCtx(mode="fp"))
            y1 = blocks[1].apply(blocks[1].params, x1, QuantCtx(mode="fp"))
        steps = 20
        r20 = dataclasses.replace(recipe, iters=steps)
        rc.clear_engine_cache()
        rc.reconstruct_block(blocks[1], r20, x1, y1, chunk=steps, mesh=mesh)
        d = RUNS_DIR / "profile_mesh"
        shutil.rmtree(d, ignore_errors=True)
        with profiler.trace(str(d)):
            rc.reconstruct_block(blocks[1], r20, x1, y1, chunk=steps,
                                 mesh=mesh)
        win = device_window(d, "recon.chunk")
        rc.clear_engine_cache()
        out["replays"] = win
        log(f"mesh world 1: 20 replays of block 1's step traced: "
            f"{win['device_ops'] / steps:.0f} device ops a step, "
            f"{win['nccl_ops']} of them NCCL's (one rank reduces in place "
            f"without device work), window {win['window_ms']:.3f} ms")

        # compressed_psum over the group against dequant(quant(g))
        gen = torch.Generator(device=DEV).manual_seed(5)
        tree = {k: torch.randn(shape, generator=gen, device=DEV)
                for k, shape in (("w_up", (576, 1536)),
                                 ("w_down", (1536, 576)), ("norm", (577,)))}
        red, res = compress.compressed_psum(tree)
        bad = [k for k, g in tree.items()
               if not torch.equal(red[k], adam._dq8(*adam._q8(g), g.shape))
               or not torch.equal(res[k], g - red[k])]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            compress.compressed_psum(tree)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 10  # eager: the collective is NCCL's
        out["compressed_psum"] = {"ms": ms, "bad": bad}
        log(f"mesh world 1: compressed_psum of {sum(g.numel() for g in tree.values())} "
            f"gradients on the card: {ms:.4f} ms, equal to dequant(quant(g)) "
            f"at {len(tree) - len(bad)} of {len(tree)} leaves")
        if bad:
            fail(f"compressed_psum differs from dequant(quant(g)) at {bad}")
    finally:
        meshes.shutdown()
    return out


def mesh_child(out_dir: str, argv) -> int:
    """One rank of the mesh phase's launcher run (under torchrun): the
    launcher's ``main(argv)``; rank 0's launch counters and K1/K2/K3 shapes
    (``PathWindow``); every rank's seconds, peak memory and its
    collectives' seconds inside the Adam loops (the device synced around
    each) into ``out_dir/rank<r>.json``."""
    import os

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import reconstruct as rc
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import quantize as launcher

    rank = int(os.environ["RANK"])
    coll = {"calls": 0, "loop_calls": 0, "loop_s": 0.0, "in_loop": False}
    real = {n: getattr(meshes.DataParallel, n) for n in ("all_reduce",
                                                          "assemble")}
    real_run = rc._Engine.run

    def timed(fn):
        def wrap(self, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            coll["calls"] += 1
            if coll["in_loop"]:
                coll["loop_calls"] += 1
                coll["loop_s"] += time.perf_counter() - t
            return res
        return wrap

    def run(self, *args, **kwargs):
        coll["in_loop"] = True
        try:
            return real_run(self, *args, **kwargs)
        finally:
            coll["in_loop"] = False

    for n, fn in real.items():
        setattr(meshes.DataParallel, n, timed(fn))
    rc._Engine.run = run
    window = PathWindow(torch) if rank == 0 else None
    torch.cuda.reset_peak_memory_stats()
    if window is not None:
        window.start()  # the mesh path's run starts here
    t0 = time.perf_counter()
    with mesh_depth():
        res = launcher.main(argv)
    torch.cuda.synchronize()
    counts = window.stop() if window is not None else None
    loop_s = sum(r.iters / r.steps_per_s for r in res.reports
                 if r.steps_per_s > 0)
    doc = {"rank": rank, "seconds": time.perf_counter() - t0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "collectives": coll["calls"], "loop_collectives": coll["loop_calls"],
           "loop_collective_s": coll["loop_s"], "loop_s": loop_s,
           "err": [(r.err_before, r.err_after) for r in res.reports],
           "loss0": [float(v) for v in res.reports[0].loss_curve],
           "engines": sorted({r.engine for r in res.reports})}
    if window is not None:
        served = res.serve
        doc.update(counts=counts, shapes=sorted(window.shapes),
                   serve_smoke_us=res.serve_smoke_us,
                   served_tokens=sum(len(v) for v in served["outputs"].values()),
                   serve_s=served["seconds"])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(doc))
    return 0


def mesh_launcher_check(torch, np, rows):
    """(b) of the mesh phase: the debug mesh's 8 ranks through torchrun,
    against one process."""
    import os

    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_config
    from repro_torch.data import CalibrationSet, SyntheticTokens
    from repro_torch.launch import quantize as launcher

    d = RUNS_DIR / "mesh"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    argv = mesh_argv() + ["--mesh", "debug", "--out", str(d / "mesh")]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(MESH_RANKS), "--master-addr", "localhost", "--master-port",
           str(_free_port()), str(ROOT / "chip_smoke.py"), "--mesh-child",
           str(d)] + argv
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with open(d / "torchrun.log", "w") as fh:
        proc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                              env=env, cwd=str(ROOT), timeout=600)
    mesh_s = time.perf_counter() - t0
    text = (d / "torchrun.log").read_text()
    if proc.returncode != 0:
        fail(f"mesh: the {MESH_RANKS}-rank launcher run exited "
             f"{proc.returncode}:\n{text[-4000:]}")
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    for line in text.splitlines():
        if line.startswith(("distributed: rank 0", "recon: the mesh",
                            "calibration:", "quantized ", "serve")):
            log(f"  [rank 0] {line}")

    args = launcher.build_parser().parse_args(mesh_argv() + [
        "--out", str(d / "one")])
    cfg = get_config(args.arch)
    cal, _ = CalibrationSet.build_sharded(SyntheticTokens(
        vocab=cfg.vocab, seq_len=args.seq, seed=0), args.calib, 2)
    t0 = time.perf_counter()
    with mesh_depth():
        one = launcher.run(args, calib_tokens=cal.tokens)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if len(one.reports) != MESH_LAYERS or len(ranks[0]["err"]) != MESH_LAYERS:
        fail(f"mesh: {len(one.reports)} and {len(ranks[0]['err'])} blocks, "
             f"not {MESH_LAYERS}")

    errs = [tuple(e) for e in ranks[0]["err"]]
    one_errs = [(r.err_before, r.err_after) for r in one.reports]
    factor = [max(a[1] / b[1], b[1] / a[1]) for a, b in zip(errs, one_errs)]
    first = float(one.reports[0].loss_curve[0])
    prefix = abs(ranks[0]["loss0"][0] - first) / first
    same_ranks = all([tuple(e) for e in r["err"]] == errs for r in ranks)
    sum_rel = abs(sum(e[1] for e in errs) - sum(e[1] for e in one_errs)) \
        / sum(e[1] for e in one_errs)
    tree, _ = load_pytree(str(d / "mesh"), device=DEV)
    shares, far, layout = {}, {}, []
    for i, (tl, ol) in enumerate(zip(tree["params"]["layers"],
                                     one.qparams["layers"])):
        for name, qt in _site_qtensors_of(tl):
            oq = dict(_site_qtensors_of(ol))[name]
            site = f"layers.{i}.{name}"
            if (qt.shape, qt.bits, qt.packed, qt.pack_axis) != (
                    oq.shape, oq.bits, oq.packed, oq.pack_axis) or \
                    not torch.equal(qt.zero, oq.zero):
                layout.append(site)
            a, b = qt.codes.int(), oq.codes.int()
            shares[site] = float((a != b).float().mean())
            if qt.bits == 4 and qt.packed:
                apart = (((a & 15) - (b & 15)).abs() > 1) | (
                    ((a >> 4) - (b >> 4)).abs() > 1)
                far[site] = float(apart.float().mean())
    worst = max(far, key=far.get)
    loop = [r["loop_collective_s"] / max(r["loop_s"], 1e-9) for r in ranks]
    r0 = ranks[0]
    log(f"mesh: {MESH_RANKS} ranks (gloo) in {mesh_s:.2f}s against one "
        f"process in {one_s:.2f}s; per rank "
        + ", ".join(f"{r['seconds']:.1f}s/{r['max_memory_allocated'] / 2**30:.2f}"
                    "GiB" for r in ranks)
        + f"; collectives {100 * min(loop):.1f}-{100 * max(loop):.1f}% of "
        f"the Adam loops ({r0['loop_collectives']} calls on rank 0 in "
        f"{r0['loop_s']:.2f}s); engines {r0['engines']}")
    log(f"mesh: block 0's losses {ranks[0]['loss0'][:3]} against one "
        f"process's {[float(v) for v in one.reports[0].loss_curve[:3]]}: the "
        f"first {prefix:.3e} apart (tolerance {MESH_FIRST_TOL}); err_after "
        f"apart by a "
        f"factor of at most {max(factor):.4f} (block "
        f"{factor.index(max(factor))}; tolerance {MESH_FACTOR}); error sums "
        f"{sum(e[1] for e in errs):.4f} (mesh) and "
        f"{sum(e[1] for e in one_errs):.4f} (one), {sum_rel:.4f} apart "
        f"(tolerance {MESH_SUM_TOL}); {len(shares)} sites, {len(layout)} "
        f"with another layout or zero point; code bytes differing: mean "
        f"{sum(shares.values()) / len(shares):.4f}, W4 bytes more than one "
        f"level apart: mean {sum(far.values()) / len(far):.4f}, max "
        f"{far[worst]:.4f} at {worst}; every rank's errors identical: "
        f"{same_ranks}; rank 0 served "
        f"{r0['served_tokens']} tokens in {r0['serve_s']:.2f}s, serve-smoke "
        f"{r0['serve_smoke_us']:.1f} us a step")
    if not same_ranks or prefix > MESH_FIRST_TOL or \
            max(factor) > MESH_FACTOR or sum_rel > MESH_SUM_TOL or layout \
            or r0["engines"] != ["eager"]:
        fail(f"mesh: the {MESH_RANKS}-rank run strays from one process "
             f"(first loss {prefix:.3e}, factor {max(factor):.4f}, sum "
             f"{sum_rel:.4f}, layout or zero points {layout[:5]}, ranks "
             f"agree {same_ranks}, engines {r0['engines']})")

    counts = r0["counts"]
    for k in ("dequant_matmul_w4", "dequant_matmul_w8", "qmatmul_int8"):
        if counts[k] == 0:
            fail(f"mesh: rank 0 did not launch {k}: {counts}")
    window = PathWindow(torch)
    window.shapes = {tuple(s) for s in r0["shapes"]}
    held_before = len(rows)
    new = check_path_shapes(torch, window, rows, "smollm-135m-mesh")
    rows.extend(new)
    log(f"mesh: rank 0 launches {counts}; {len(window.shapes)} K1/K2/K3 "
        f"shapes, {len(window.shapes) - len(new)} held before this phase, "
        f"{len(new)} held now ({held_before} rows before)")
    shutil.rmtree(d, ignore_errors=True)
    return counts, {"seconds": mesh_s, "one_seconds": one_s, "ranks": ranks,
                    "first_loss_rel": prefix, "err_factor": factor,
                    "err_sum_rel": sum_rel,
                    "code_share": shares, "w4_far_share": far,
                    "new_shapes": [r["M"] for r in new]}


def _site_qtensors_of(tree, prefix=""):
    if hasattr(tree, "codes"):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _site_qtensors_of(v, f"{prefix}{k}.")


def mesh_production_refusal():
    """(c) of the mesh phase: ``--mesh production`` in one process."""
    from repro_torch.launch import quantize as launcher
    try:
        launcher.main(launcher_argv(0) + ["--mesh", "production"])
    except SystemExit as e:
        msg = str(e.code)
        if "256 ranks" not in msg or "world size of 1" not in msg:
            fail(f"mesh: --mesh production exited without the world-size "
                 f"message: {msg}")
        log(f"mesh: --mesh production refused: {msg[:160]}...")
        return msg
    fail("mesh: --mesh production did not exit in a world of one")


# A MoE block on a mesh (tests/test_torch_moe_mesh.py's case on the card):
# the reduced llama4-scout with llama4-scout's capacity factor, moe_group =
# one minibatch of 4 rows x 16 tokens, 8 calibration rows; 2 gloo ranks on
# the one card (a full-width llama4 layer's S2, Adam moments and gradients,
# ~32 GB a rank, do not fit two ranks on one card) against one process.
MOE_MESH_N, MOE_MESH_S, MOE_MESH_BS, MOE_MESH_ITERS = 8, 16, 4, 3
MOE_MESH_RANKS = 2
# Tolerances. The CPU test's: the teacher 1e-6 (rtol = atol), the first
# loss and err_before 1e-6. On the card one process's float32 forward is
# not invariant to how many rows a call holds: block(x[:4]) against
# block(x[:2]) and block(x[2:4]) differ by 1.3e-6 (smollm smoke block), this
# llama4 block's 8 rows against 4 + 4 by 2.6e-6 (H100 80GB HBM3, 700 W),
# where the CPU's agree. So the teacher is held to twice that floor,
# measured in the same run (8 against 4 + 4 rows: whole groups, nothing
# regroups), plus the CPU test's 1e-6; and Adam carries the floor into
# the 3-step trajectory (measured: the full batch's loss 1.1e-6,
# err_after 6.3e-5, the states 3.1x the CPU test's 2e-5 + 2e-4 of 3
# steps' move), which is held at 1e-4 relative (loss, err_after) and
# 1e-4 relative plus 10x the move (states). A regrouped block misses by
# 8-32% in the first loss and the curve (on the CPU, with the groups
# picked from a rank's own tokens).
MOE_MESH_TOL = 1e-6
MOE_MESH_CURVE_TOL = 1e-4
MOE_MESH_STATE_TOL = (1e-4, 10 * 2e-4 * 3e-3 * MOE_MESH_ITERS)


def _moe_mesh_block(torch, params, calib):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config("llama4-scout-17b-a16e"),
                              capacity_factor=1.25,
                              moe_group=MOE_MESH_BS * MOE_MESH_S)
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        params = model.init(gen, device=DEV)
    x0, blocks, _ = model.quant_blocks(params, calib)
    return params, x0, blocks[0]


def _moe_mesh_runs(torch, block, x0, y8, idx, mesh):
    """The teacher over 4 rows (half a group a rank: gathered) and over 8
    (a whole group a rank), both gathered to the whole stream; the full
    batch of 4 rows and the minibatches of 4 of 8 rows (``idx``), weights
    only, ``MOE_MESH_ITERS`` steps."""
    from repro_torch.core import reconstruct as rc
    from repro_torch.core.quant_config import QuantRecipe
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=None,
                         w_granularity="per_channel", setting="brecq",
                         lr=3e-3, batch_size=MOE_MESH_BS, iters=MOE_MESH_ITERS)
    dp = rc._data_parallel(mesh)
    out = {}
    for tag, x in (("teacher4", x0[:4]), ("teacher8", x0)):
        rows = rc._Rows.of(dp, x.shape[0])
        y = rc.probe_teacher(block, recipe, mesh, rows=rows)(
            block.params, rows.take(x))
        out[tag] = rows.gather(y).float().cpu()
    for tag, x, y, sched in (
            ("fb", x0[:4], y8[:4], None),
            ("mb", x0, y8, rc.Schedule(idx.cpu().numpy(), None))):
        ws, _, r = rc.reconstruct_block(block, recipe, x, y, 3,
                                        schedule=sched, mesh=mesh)
        out[tag] = {"ws": {k: {n: t.float().cpu() for n, t in v.items()}
                           for k, v in ws.items()},
                    "loss": [float(v) for v in r.loss_curve],
                    "err": (r.err_before, r.err_after), "engine": r.engine}
    return out


def moe_mesh_child(out_dir: str) -> int:
    """One rank of the MoE mesh check (under torchrun)."""
    import os

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as meshes
    meshes.init_distributed(torch.device("cuda"))
    data = torch.load(Path(out_dir, "data.pt"), map_location="cuda")
    _, x0, block = _moe_mesh_block(torch, data["params"], data["calib"])
    res = _moe_mesh_runs(torch, block, x0, data["y8"], data["idx"],
                         meshes.make_flat_mesh(MOE_MESH_RANKS,
                                               device_type="cuda"))
    torch.save(res, Path(out_dir, f"rank{os.environ['RANK']}.pt"))
    meshes.shutdown()
    return 0


def mesh_moe_check(torch, np):
    """(d) of the mesh phase: a MoE block whose minibatch is one token
    group, half of it on each of 2 gloo ranks, against one process."""
    import os

    from repro_torch.core import reconstruct as rc

    d = RUNS_DIR / "moe_mesh"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    gen = torch.Generator()
    gen.manual_seed(1)
    calib = torch.randint(0, 128, (MOE_MESH_N, MOE_MESH_S),
                          generator=gen).to(DEV)
    params, x0, block = _moe_mesh_block(torch, None, calib)
    y8 = rc.probe_teacher(block, None)(block.params, x0)
    idx = rc._batch_schedule(gen, MOE_MESH_ITERS, MOE_MESH_N, MOE_MESH_BS)
    torch.save({"params": params, "calib": calib, "y8": y8, "idx": idx},
               d / "data.pt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(MOE_MESH_RANKS), "--master-addr", "localhost", "--master-port",
           str(_free_port()), str(ROOT / "chip_smoke.py"), "--moe-mesh-child",
           str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    with open(d / "torchrun.log", "w") as fh:
        proc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                              env=env, cwd=str(ROOT), timeout=300)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"mesh: the MoE {MOE_MESH_RANKS}-rank run exited "
             f"{proc.returncode}:\n{(d / 'torchrun.log').read_text()[-4000:]}")
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(MOE_MESH_RANKS)]
    one = _moe_mesh_runs(torch, block, x0, y8, idx, None)
    worst, bad = {}, []

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    # the card's row-count floor: the 8 rows in one call against two calls
    # of 4 (whole groups both ways, so nothing regroups)
    teacher = rc.probe_teacher(block, None)
    split = torch.cat([teacher(block.params, x0[:4]),
                       teacher(block.params, x0[4:])]).float().cpu()
    floor = worst["floor"] = (split - one["teacher8"]).abs().max().item()
    for tag in ("teacher4", "teacher8"):
        diff = (ranks[0][tag] - one[tag]).abs()
        worst[tag] = diff.max().item()
        worst[f"{tag}_over_tol"] = (diff / (2 * floor + MOE_MESH_TOL + (
            MOE_MESH_TOL * one[tag].abs()))).max().item()
        if worst[f"{tag}_over_tol"] > 1:
            bad.append(tag)
    for tag in ("fb", "mb"):
        got, want = ranks[0][tag], one[tag]
        worst[f"{tag}_first_loss"] = rel(got["loss"][0], want["loss"][0])
        worst[f"{tag}_loss"] = rel(got["loss"], want["loss"])
        worst[f"{tag}_err_before"] = rel(got["err"][0], want["err"][0])
        worst[f"{tag}_err_after"] = rel(got["err"][1], want["err"][1])
        rtol, atol = MOE_MESH_STATE_TOL
        st = 0.0
        for site, v in want["ws"].items():
            for k, t in v.items():
                diff = (got["ws"][site][k] - t).abs()
                st = max(st, (diff / (atol + rtol * t.abs())).max().item())
        worst[f"{tag}_states_over_tol"] = st
        bad += [f"{tag}_{k}" for k, lim in (
            ("first_loss", MOE_MESH_TOL), ("err_before", MOE_MESH_TOL),
            ("loss", MOE_MESH_CURVE_TOL), ("err_after", MOE_MESH_CURVE_TOL),
            ("states_over_tol", 1.0)) if worst[f"{tag}_{k}"] > lim]
        if any(r[tag]["loss"] != got["loss"] for r in ranks[1:]):
            bad.append(f"{tag}: the ranks' losses differ")
    if bad:
        fail(f"mesh: MoE block against one process: {bad} beyond the "
             f"tolerances: {worst}")
    log(f"mesh: MoE block on {MOE_MESH_RANKS} gloo ranks ({ranks_s:.1f}s, "
        f"engine {ranks[0]['fb']['engine']}) against one process "
        f"(engine {one['fb']['engine']}): " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    shutil.rmtree(d, ignore_errors=True)
    return {"seconds": ranks_s, "worst": worst,
            "first_loss": ranks[0]["fb"]["loss"][0],
            "loss": {t: (ranks[0][t]["loss"], one[t]["loss"])
                     for t in ("fb", "mb")}}


# ------------------------------------------------------------------ cells
# The cell programs on the card (``launch.steps.build_cell`` on a mesh of
# one rank): (arch, shape, weights, kv, warm steps, timed steps). Each runs
# at its shape's sequence length with a batch of the shape's global batch
# over CELL_DATA, the data axis of the 16 x 16 layout (at least 1); a
# decode cell's steps take the cache's last positions. The prefill cell's
# plain run goes first and warms what the two runs share (a prefill takes
# ~11 s on an H100: PERF.md). CELL_TOL: the plain re-runs' relative L2, as
# every path's
CELLS = (("smollm-135m", "train_4k", "bf16", "bf16", 1, 1),
         ("smollm-135m", "prefill_32k", "int8", "bf16", 0, 1),
         ("smollm-135m", "decode_32k", "bf16", "bf16", 1, 10),
         ("smollm-135m", "decode_32k", "int8", "bf16", 1, 10),
         ("smollm-135m", "decode_32k", "int4", "bf16", 1, 10),
         ("smollm-135m", "decode_32k", "int4", "int8", 1, 10),
         ("mamba2-130m", "long_500k", "int8", "bf16", 1, 10))
CELL_DATA = 16
CELL_TOL = 5e-2


def cell_shape(name: str):
    from repro_torch.configs import ShapeSpec, get_shape
    s = get_shape(name)
    return ShapeSpec(s.name, s.seq_len, max(1, s.global_batch // CELL_DATA),
                     s.kind)


def _tmap(fn, tree):
    from repro_torch.launch import specs
    return specs.map_with_path(lambda _, t: fn(t), tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key],
                                                       f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{path}.{i}").items()}
    return {path: tree}


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _token_check(tok, logits):
    """The kernel run's next tokens (B, 1) against the plain run's logits
    (B, 1, V): (tokens, differing, near-ties). A token may differ only
    where the plain run's top-2 gap is within CELL_TOL of its largest
    logit's magnitude."""
    lf = logits.float()
    top2 = lf.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= CELL_TOL * lf.abs().amax(dim=-1)
    diff = lf.argmax(dim=-1) != tok
    return int(tok.numel()), int(diff.sum()), int((diff & near).sum())


def _timed(torch, fn, n_warm, n_timed):
    """``fn(i)`` for i in range(n_warm + n_timed), each between CUDA
    events; returns (ms of the timed calls, the last result)."""
    ms, out = [], None
    for i in range(n_warm + n_timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(i)
        end.record()
        end.synchronize()
        if i >= n_warm:
            ms.append(start.elapsed_time(end))
    return ms, out


CELL_TRACED_STEPS = 2  # decode steps of each smollm decode cell traced


def trace_cell_steps(torch, fn, steps, tag):
    """``fn(i)`` for i in range(steps), each annotated ``cell.step``, traced
    with obs.profiler after one untraced call: ``device_window``'s numbers
    over their window."""
    from repro_torch.obs import profiler
    d = RUNS_DIR / f"profile_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    fn(0)
    torch.cuda.synchronize()
    with profiler.trace(str(d)):
        for i in range(steps):
            with profiler.annotate("cell.step", i):
                fn(i)
        torch.cuda.synchronize()
    return device_window(d, "cell.step")


def run_cell(torch, np, arch, shape_name, weights, kv, n_warm, n_timed):
    """One cell: its program from ``build_cell``, real arguments drawn from
    its stand-ins (seed 0), ``n_warm + n_timed`` calls of ``prog.fn``; a
    serve cell then once more with the plain versions along the same
    inputs. Returns the cell's record (``roofline.report``'s format plus
    the measurements)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, specs, steps
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import adam_init
    from repro_torch.roofline import analysis

    cfg, shape = get_config(arch), cell_shape(shape_name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors
    t0 = time.perf_counter()
    prog = steps.build_cell(cfg, shape, AbstractMesh((1, 1), ("data", "model")),
                            weights=weights, kv=kv)
    model = build_model(cfg)
    gen = torch.Generator(device=DEV).manual_seed(0)
    fp = model.init(gen, device=DEV)

    def draw_tokens(meta):
        return torch.randint(0, cfg.vocab, tuple(meta.shape), generator=gen,
                             device=DEV, dtype=torch.int32)

    before = ops.launch_counts()
    rec = {"cell": f"{arch}|{shape_name}|{shape.seq_len}x{shape.global_batch}"
                   f"|{weights}|kv-{kv}", "status": "ok"}
    if shape.kind == "train":
        opt = steps.TRAIN_OPT[sharding.ARCH_MODE.get(cfg.name, "tp")]
        state = {"params": fp, "opt": adam_init(fp, opt), "step": 0}
        batch = {k: draw_tokens(v) for k, v in prog.args[1].items()}
        del fp
        losses = []

        def step(i):
            nonlocal state
            state, m = prog.fn(state, batch)
            losses.append((float(m["loss"]), float(m["gnorm"])))

        ms, _ = _timed(torch, step, n_warm, n_timed)
        peak = torch.cuda.max_memory_allocated()
        if state["step"] != n_warm + n_timed or not all(
                math.isfinite(a) and math.isfinite(b) for a, b in losses):
            fail(f"cell {prog.name}: step {state['step']}, (loss, gnorm) "
                 f"{losses}")
        rec["train"] = {"loss_gnorm": losses}
        del state, batch
    else:
        params = specs.materialize(prog.args[0], gen, DEV, fill=fp)
        del fp
        plain = (steps.make_prefill_step if shape.kind == "prefill"
                 else steps.make_serve_step)(model, cfg, "torch", logits=True)
        if shape.kind == "prefill":
            cache = _tmap(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                device=DEV), prog.args[2])
            tokens = draw_tokens(prog.args[1])
            extra = [specs.materialize(a, gen, DEV) for a in prog.args[3:]]
            # the plain run first: it also warms what both runs share (the
            # attention, the allocator); the kernel run then writes the
            # same cache again
            _, pcache, plog = plain(params, tokens, cache, *extra)
            pcache = _tmap(lambda t: t.clone(), pcache)
            torch.cuda.reset_peak_memory_stats()
            ms, (tok, kernel_cache) = _timed(
                torch, lambda i: prog.fn(params, tokens, cache, *extra),
                n_warm, n_timed)
            peak = torch.cuda.max_memory_allocated()
            toks = [(tok, plog)]
            window = slice(None)
        else:
            # drawn as a long prefill would leave it; an attention cache is
            # written at each step's position before it is read there, so
            # the plain run replays the same positions over the same buffer
            # (a recurrent state is overwritten whole: copied first)
            cache = specs.materialize(prog.args[2], gen, DEV)
            recurrent = cfg.family in ("ssm", "hybrid")
            start_state = _tmap(lambda t: t.clone(), cache) if recurrent \
                else None
            first = shape.seq_len - n_warm - n_timed
            inputs = [draw_tokens(prog.args[1])]

            def step(i):
                nonlocal cache
                tok, cache = prog.fn(params, inputs[-1], cache, first + i)
                inputs.append(tok)

            ms, _ = _timed(torch, step, n_warm, n_timed)
            peak = torch.cuda.max_memory_allocated()
            window = slice(None) if recurrent else slice(first, None)
            kernel_cache = _tmap(
                lambda t: t.clone() if recurrent or t.dim() < 3
                else t[:, :, window].clone(), cache)
            pcache = start_state if recurrent else cache
            toks = []
            for i in range(n_warm + n_timed):
                _, pcache, plog = plain(params, inputs[i], pcache, first + i)
                toks.append((inputs[i + 1], plog))
            if not recurrent:  # the kernel run's first steps again, traced
                rec["trace"] = trace_cell_steps(
                    torch, lambda i: prog.fn(params, inputs[i], cache,
                                             first + i),
                    CELL_TRACED_STEPS, f"cell_{weights}_{kv}")
        torch.cuda.synchronize()
        got = _flat(kernel_cache)
        want = {k: (v if v.dim() < 3 or window == slice(None)
                    else v[:, :, window]) for k, v in _flat(pcache).items()}
        rel = {k: _rel_l2(got[k], want[k]) for k in want}
        n_tok = n_diff = n_near = 0
        for tok, plog in toks:
            a, b, c = _token_check(tok, plog)
            n_tok, n_diff, n_near = n_tok + a, n_diff + b, n_near + c
        rec["plain"] = {"cache_rel_l2": rel, "tokens": n_tok,
                        "differ": n_diff, "near_ties": n_near}
        if max(rel.values()) > CELL_TOL or n_diff != n_near or any(
                not math.isfinite(v) for v in rel.values()):
            fail(f"cell {prog.name}: against the plain versions caches "
                 f"{rel}, {n_diff} of {n_tok} tokens differ ({n_near} "
                 f"near-ties)")
        del params, cache, pcache, kernel_cache, got, want, toks
    torch.cuda.synchronize()
    after = ops.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    a = analysis.analyze(cfg, shape, 1, weights, kv=kv, card=PEAKS)
    med = float(np.median(ms))
    rec.update(
        name=prog.name, seq_len=shape.seq_len, batch=shape.global_batch,
        ms=med, ms_all=ms, seconds=time.perf_counter() - t0,
        memory={"peak_bytes_per_device": peak, "held_before_bytes": held},
        analysis=a, fraction=a["step_time_bound_s"] * 1e3 / med,
        mfu=analysis.model_flops(cfg, shape, 1) / (
            med * 1e-3 * PEAKS.ops["bfloat16"]),
        launches=launches)
    k1 = launches.get("dequant_matmul_w4", 0)
    k2 = launches.get("dequant_matmul_w8", 0)
    want = {"bf16": (False, False), "int8": (False, True),
            "int4": (True, False)}[weights]
    if ((k1 > 0, k2 > 0) != want or set(launches) - {
            "dequant_matmul_w4", "dequant_matmul_w8", "dequant_matmul_w4[decode]",
            "dequant_matmul_w4[mma]", "dequant_matmul_w8[decode]",
            "dequant_matmul_w8[mma]"}):
        fail(f"cell {prog.name}: launches {launches}, want K1/K2 {want}")
    line = (f"cell {prog.name} ({shape.seq_len} x {shape.global_batch}, kv "
            f"{kv}): {med:.3f} ms (median of {len(ms)}), bound "
            f"{a['step_time_bound_s'] * 1e3:.4f} ms ({a['bottleneck']}; "
            f"compute {a['compute_s']:.4e} s, memory {a['memory_s']:.4e} s), "
            f"fraction {rec['fraction']:.4f}, MFU {rec['mfu']:.5f}, peak "
            f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held before the cell), "
            f"K1 {k1} K2 {k2} launches")
    if "plain" in rec:
        p = rec["plain"]
        line += (f"; plain versions: cache rel L2 <= "
                 f"{max(p['cache_rel_l2'].values()):.3e}, {p['tokens'] - p['differ']}"
                 f"/{p['tokens']} tokens equal, {p['near_ties']} near-ties")
    else:
        line += f"; (loss, gnorm) {[tuple(round(v, 4) for v in x) for x in rec['train']['loss_gnorm']]}"
    log(line)
    if "trace" in rec:
        t = rec["trace"]
        share = t["device_busy_share"]
        log(f"  traced {t['marks']} steps: window {t['window_ms']:.3f} ms, "
            f"device busy {t['device_busy_ms']:.3f} ms ("
            f"{'not measured' if share is None else f'{100 * share:.1f}%'}), "
            f"{t['device_ops'] // t['marks']} device ops a step, "
            f"{t['host_syncs']} host syncs, {t['copies_to_device']} copies "
            "to the device; top 5: " + "; ".join(
                f"{x['name'][:60]} {x['ms']:.3f} ms" for x in t["top5"]))
    return rec


def cells_phase(torch, np, rows):
    """The cell programs on the card (the docstring's phase 14): every cell
    of CELLS in one counter window (the main path of this phase), then
    every K1/K2 shape the window gave held against its plain version.
    Returns (launch counts, cell records)."""
    window = PathWindow(torch)
    window.start()  # the cells' run starts here
    recs = [run_cell(torch, np, *c) for c in CELLS]
    counts = window.stop()  # ... and ends here
    rows.extend(check_path_shapes(torch, window, rows, "cells"))
    for k in ("dequant_matmul_w4", "dequant_matmul_w8"):
        if counts[k] == 0:
            fail(f"cells: {k} was not launched: {counts}")
    from repro_torch.roofline import report
    cells = {r["cell"]: r for r in recs}
    for line in report.summary(cells).splitlines():
        log(f"cells: {line}")
    return counts, recs


def mesh_phase(torch, np, rows):
    """Data-parallel calibration on the card (the docstring's phase 13).
    Returns rank 0's launch counts and the phase's numbers."""
    world1 = mesh_world1_check(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    counts, ranks = mesh_launcher_check(torch, np, rows)
    production = mesh_production_refusal()
    moe = mesh_moe_check(torch, np)
    return counts, {"world1": world1, "launcher": ranks,
                    "production": production, "moe": moe}


# ---------------------------------------------------------------- dry run
# (a): the production cells, full size, traced on fake process groups in
# three child processes on the host (they need no card; more slow the
# host-bound phases), at the lowest priority, started after the kernels
# phase and read at the end
DRY_CELLS = (("smollm-135m", "train_4k", False), ("smollm-135m", "train_4k", True),
             ("smollm-135m", "prefill_32k", False),
             ("smollm-135m", "prefill_32k", True),
             ("smollm-135m", "decode_32k", False),
             ("smollm-135m", "decode_32k", True),
             ("llama4-scout-17b-a16e", "train_4k", False))
# three children of about equal work, the two prefill traces (the longest:
# 348-490 s each on the card's host) apart
DRY_GROUPS = ((2, 4, 5), (3, 0), (1, 6))
DRY_WEIGHTS = "int8"
# the children's files: beside RUNS_DIR, which the phases empty between them
DRY_DIR = ROOT / "build" / "chip_smoke_dryrun"
# (b): the traced programs on 2 ranks of the card (gloo: NCCL refuses two
# ranks on one device), 4 layers at full width: smollm-135m's decode cell
# (int8 weights: K2 on local shards; the cells phase's shape, the batch
# over 16) on (1, 2), its train cell (dp) on (2, 1), olmo-1b's train cell
# (tp: 16 heads divide the model axis) at 4 x 4096 on (1, 2); the train
# cells' models in float32, so the sides agree to float order. Gloo
# carries all-reduce on CUDA tensors and nothing else this needs: its
# all_gather_into_tensor on CUDA tensors ends the process (SIGSEGV in the
# wait, on an H100 with torch 2.11); a cell whose trace holds another kind
# runs at world 1 only, and the CPU ranks of
# tests/test_torch_sharded_cells.py hold it
SHARDED_LAYERS = 4
SHARDED_RANKS = 2
SHARDED_RUNS = {"decode": ("smollm-135m", (1, 2)),
                "train_dp": ("smollm-135m", (2, 1)),
                "train_tp": ("olmo-1b", (1, 2))}
GLOO_CUDA = ("all-reduce",)
# per entry, of the largest magnitude (the CPU ranks' bound): one token
# written to a wrong slot or lost is far beyond it
SHARDED_CACHE_ATOL = SHARDED_CACHE_RTOL = 1e-5
SHARDED_LOSS_TOL = 1e-5     # relative, float32 loss and gradient norm
LIMIT_S = 1200.0  # the whole script's limit: the children's waits end before
T_START = time.perf_counter()


def dryrun_child(out_path: str, cells) -> int:
    """One dry-run child: ``launch.dryrun.run_cell`` of each ``arch:shape:
    multi_pod`` cell on the fake group of its mesh; the records and the
    child's CPU seconds into ``out_path``."""
    import os
    os.nice(19)  # the host's spare cycles: the phases on the card come first
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_layout
    todo = [(a, s, m == "1") for a, s, m in (c.split(":") for c in cells)]
    recs = []
    for mp in (False, True):
        mine = [c for c in todo if c[2] == mp]
        if not mine:
            continue
        with dryrun.fake_world(math.prod(
                mesh_layout("production", multi_pod=mp)[0])):
            for arch, shape, _ in mine:
                recs.append(dryrun.run_cell(arch, shape, multi_pod=mp,
                                            weights=DRY_WEIGHTS))
                Path(out_path).write_text(json.dumps(
                    {"records": recs, "cpu_s": time.process_time()}))
    return 0


_CHILDREN = []


def _stop_children():
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


@contextlib.contextmanager
def children_paused():
    """The dry-run children stopped (SIGSTOP) for the block and continued
    after: the mesh phase runs 8 ranks on the host's 8 cores, which even
    niced children slow by half (the children have time to spare)."""
    import signal
    live = [p for p in _CHILDREN if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGSTOP)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for p in live:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
        log(f"dry run: {len(live)} children paused for "
            f"{time.perf_counter() - t0:.1f}s")


def dryrun_start():
    """Start part (a)'s children (one thread each, CUDA visible so the
    meshes are CUDA meshes of fake tensors); returns their handles."""
    import atexit
    import os
    d = DRY_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    handles = []
    for i, group in enumerate(DRY_GROUPS):
        cells = [f"{a}:{s}:{int(mp)}" for a, s, mp in
                 (DRY_CELLS[j] for j in group)]
        fh = open(d / f"child{i}.log", "w")
        p = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
             str(d / f"child{i}.json")] + cells, stdout=fh,
            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        _CHILDREN.append(p)
        handles.append((p, d / f"child{i}.json", d / f"child{i}.log", fh))
    fh = open(d / "sharded_trace.log", "w")
    p = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-trace-child",
         str(d / "sharded_trace.json")], stdout=fh, stderr=subprocess.STDOUT,
        env=env, cwd=str(ROOT))
    _CHILDREN.append(p)
    atexit.register(_stop_children)
    log(f"dry run: {len(DRY_CELLS)} cells started in {len(handles)} child "
        "processes on the host, part (b)'s traces in one more")
    return {"handles": handles, "t0": time.perf_counter(),
            "sharded_trace": (p, d / "sharded_trace.json",
                              d / "sharded_trace.log", fh)}


def dryrun_finish(started, timeout: float = 240.0):
    """Part (a)'s end: wait for the children (at most ``timeout`` seconds,
    and never past ``LIMIT_S`` less a margin), print each cell and the
    report's table; fail unless every cell traced with all three terms."""
    from repro_torch.roofline import report
    t_wait = time.perf_counter()
    timeout = min(timeout, _left(30.0))
    recs, cpu_s = [], [started["trace_cpu_s"]]
    for handle in started["handles"]:
        res = _wait_child(handle, max(
            timeout - (time.perf_counter() - t_wait), 1.0), "dry run")
        recs += res["records"]
        cpu_s.append(res["cpu_s"])
    waited = time.perf_counter() - t_wait
    for r in recs:
        if r["status"] != "ok":
            fail(f"dry run: {r['cell']}: {r.get('error', r.get('reason'))}")
        a, m = r["analysis"], r["memory"]
        if a["bottleneck"] not in ("compute", "memory", "collective") or \
                "collective_s" not in a:
            fail(f"dry run: {r['cell']} lacks a term: {a}")
        coll = ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in
                         a["collective_breakdown"].items() if v)
        log(f"dry run: {r['cell']} ({r['mesh_device']} mesh): traced in "
            f"{r['trace_s']:.1f}s, {r['nodes']} nodes; peak "
            f"{m['peak_bytes_per_device'] / 2**30:.3f} GiB/device (arguments "
            f"{m['argument_bytes'] / 2**30:.3f}); collectives per device "
            f"{coll or 'none'}; on {a['card']}: compute {a['compute_s']:.3e}s,"
            f" memory {a['memory_s']:.3e}s, collective {a['collective_s']:.3e}"
            f"s -> {a['bottleneck']}")
    cells = {r["cell"]: r for r in recs}
    for line in report.summary(cells).splitlines():
        log(f"dry run: {line}")
    for line in report.markdown(cells).splitlines():
        log(f"dry run: {line}")
    total = time.perf_counter() - started["t0"]
    log(f"dry run: {len(recs)} cells in {total:.1f}s since the start, "
        f"{waited:.1f}s of them waited for at the end; the children's CPU "
        f"seconds {sum(cpu_s):.1f} (" + ", ".join(f"{c:.1f}" for c in cpu_s)
        + ", the last three part (a)'s), spent beside every phase from the "
        "analysis phase on but the mesh phase")
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    return {"cells": recs, "seconds": total, "waited_s": waited,
            "children_cpu_s": cpu_s}


def sharded_cell(kind: str):
    """(cfg, shape, weights, mode, mesh shape) of part (b)'s ``kind``."""
    from repro_torch.configs import ShapeSpec, get_config
    arch, mesh = SHARDED_RUNS[kind]
    cfg = dataclasses.replace(get_config(arch), n_layers=SHARDED_LAYERS)
    if kind == "decode":
        return cfg, cell_shape("decode_32k"), "int8", None, mesh
    cfg = dataclasses.replace(cfg, dtype="float32")
    if kind == "train_dp":
        return cfg, cell_shape("train_4k"), "bf16", "dp", mesh
    return cfg, ShapeSpec("train_4k", 4096, 4, "train"), "bf16", "tp", mesh


def sharded_args(torch, kind: str):
    """Part (b)'s arguments, the same in every process (drawn on the card
    from seed 0): the model's init (a train state, or int8 QTensors of
    drawn codes), drawn tokens and cache; a decode step at the cache's
    last position."""
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import adam_init
    cfg, shape, weights, mode, _ = sharded_cell(kind)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = build_model(cfg).init(gen, device=DEV)
    prog = steps.build_cell(cfg, shape, AbstractMesh((1, 1), ("data", "model")),
                            weights=weights, mode=mode)

    def tokens(meta):
        return torch.randint(0, cfg.vocab, tuple(meta.shape), generator=gen,
                             device=DEV, dtype=torch.int32)

    if shape.kind == "train":
        opt = steps.TRAIN_OPT[mode]
        return ({"params": params, "opt": adam_init(params, opt), "step": 0},
                {k: tokens(v) for k, v in prog.args[1].items()})
    qparams = specs.materialize(prog.args[0], gen, DEV, fill=params)
    cache = specs.materialize(prog.args[2], gen, DEV)
    return qparams, tokens(prog.args[1]), cache, shape.seq_len - 1


def _on(torch, tree, dev):
    """``tree``'s tensors (QTensor fields too) on ``dev``."""
    from repro_torch.launch import specs

    def one(_, t):
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        if hasattr(t, "codes"):
            return dataclasses.replace(t, **{f: getattr(t, f).to(dev) for f in
                                             ("codes", "scale", "zero")})
        return t
    return specs.map_with_path(one, tree)


def run_sharded(torch, kind: str, mesh):
    """The cell of ``kind`` on ``mesh`` (a ``DeviceMesh``, or None: the
    plain program of a world of one) over ``sharded_args``. Returns
    (results on the CPU: a train cell's loss and gradient norm, a decode
    cell's tokens and cache; eager collective counts by kind, launch
    counts, seconds)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.core.dist import is_dtensor
    from repro_torch.roofline.collectives import counts_by_kind
    cfg, shape, weights, mode, _ = sharded_cell(kind)
    args = sharded_args(torch, kind)
    prog = steps.build_cell(
        cfg, shape, mesh or AbstractMesh((1, 1), ("data", "model")),
        weights=weights, mode=mode)
    n = len(prog.in_shardings)
    if mesh is not None:
        args = sharding.distribute(mesh, args[:n], prog.in_shardings) + \
            tuple(args[n:])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with CommDebugMode() as comm:
        out = prog.fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    if shape.kind == "train":  # the scalars (all-reduced): no gather
        out = {k: float(v.full_tensor() if is_dtensor(v) else v)
               for k, v in out[1].items() if k in ("loss", "gnorm")}
    else:
        out = _on(torch, sharding.gather(out), "cpu")
    return out, counts_by_kind(comm.get_comm_counts()), launches, secs


def sharded_trace_child(out_path: str) -> int:
    """Part (b)'s traces, on the host beside part (a): each cell on a fake
    group of 2 ranks and a fresh mesh of its shape (CUDA where PyTorch has
    CUDA, as the ranks' is); its collective counts and the child's CPU
    seconds into ``out_path``."""
    import os
    os.nice(19)
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.roofline.collectives import collective_counts
    out = {}
    with dryrun.fake_world(SHARDED_RANKS):
        for kind in SHARDED_RUNS:
            cfg, shape, weights, mode, mesh = sharded_cell(kind)
            gm, secs = dryrun.trace_cell(
                cfg, shape, init_device_mesh(dryrun.mesh_device(), mesh,
                                             mesh_dim_names=("data", "model")),
                weights=weights, mode=mode, pos=shape.seq_len - 1)
            out[kind] = {"counts": collective_counts(gm), "trace_s": secs}
            Path(out_path).write_text(json.dumps(
                {"kinds": out, "cpu_s": time.process_time()}))
    return 0


def sharded_child(out_dir: str, kinds) -> int:
    """One rank of part (b) (under torchrun, gloo on the card): the eager
    DTensor run of each cell of ``kinds`` on a mesh of its shape, rank 0's
    K1/K2/K3 shapes recorded (``PathWindow``); rank 0 saves the results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as meshes

    meshes.init_distributed(torch.device(DEV))
    rank = dist.get_rank()
    doc = {"rank": rank, "backend": str(dist.get_backend())}
    try:
        for kind in kinds:
            print(f"[rank {rank}] {kind}: running", flush=True)
            window = PathWindow(torch) if rank == 0 else None
            if window is not None:
                window.start()
            try:
                res, eager, launches, secs = run_sharded(
                    torch, kind, init_device_mesh(
                        DEV, sharded_cell(kind)[4],
                        mesh_dim_names=("data", "model")))
            finally:
                if window is not None:
                    window.stop()
            doc[kind] = {"eager": eager, "launches": launches,
                         "seconds": secs, "max_memory_allocated":
                             torch.cuda.max_memory_allocated()}
            if window is not None:
                doc[kind]["shapes"] = sorted(window.shapes)
                torch.save(res, Path(out_dir, f"{kind}.pt"))
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(doc))
        meshes.shutdown()
    return 0


def _compare_decode(torch, res, ref, where):
    """(tokens, differing, near-ties, the cache's largest |difference|
    over its entry's bound) of a decode result against ``ref`` = (tokens,
    cache, logits)."""
    (tok, cache), (rtok, rcache, logits) = res, ref
    n, diff, near = _token_check(tok.to(rtok.device), logits)
    ca, cb = _flat(cache), _flat(rcache)
    over = 0.0
    for k in cb:
        b = cb[k].float()
        bound = SHARDED_CACHE_ATOL + SHARDED_CACHE_RTOL * b.abs().max()
        over = max(over, ((ca[k].float() - b).abs().max() / bound).item())
    if diff != near or over > 1.0:
        fail(f"sharded {where}: {diff} of {n} tokens differ ({near} near "
             f"ties), cache difference {over:.3e} of its bound "
             f"({SHARDED_CACHE_ATOL} + {SHARDED_CACHE_RTOL} x max)")
    return n, diff, near, over


def _left(margin: float) -> float:
    """Seconds left of ``LIMIT_S`` since the script started, less
    ``margin`` (what must still run after the wait), at least 1."""
    return max(LIMIT_S - margin - (time.perf_counter() - T_START), 1.0)


def _wait_child(handle, timeout: float, what: str):
    p, out, logf, fh = handle
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop_children()
        fail(f"{what}: a child outlived {timeout:.0f}s of waiting:\n"
             f"{logf.read_text()[-3000:]}")
    finally:
        fh.close()
    if p.returncode != 0 or not out.exists():
        fail(f"{what}: a child exited {p.returncode}:\n"
             f"{logf.read_text()[-3000:]}")
    return json.loads(out.read_text())


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def sharded_phase(torch, np, rows, started):
    """Part (b): the plain cell program and the world of one (an NCCL
    group of one rank, a (1, 1) CUDA mesh) in process, then the cells that
    gloo can carry on 2 ranks through torchrun, held against both; each
    rank's ``CommDebugMode`` counts against part (b)'s traces (the trace
    child). Returns (the world of one's decode launches: K2 on its
    shard, the main path of this phase; the record)."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model

    traced = _wait_child(started["sharded_trace"], min(300.0, _left(150.0)),
                         "sharded traces")
    started["trace_cpu_s"] = traced["cpu_s"]
    traced = traced["kinds"]
    ran = [k for k in SHARDED_RUNS
           if set(traced[k]["counts"]) <= set(GLOO_CUDA)]
    refused = {k: sorted(set(traced[k]["counts"]) - set(GLOO_CUDA))
               for k in SHARDED_RUNS if k not in ran}
    modes = {sharded_cell(k)[3] or "tp" for k in ran}
    if not {"dp", "tp"} <= modes:
        fail(f"sharded: gloo carries no dp and tp cell on the card: ran "
             f"{ran}, refused {refused}")

    plain = {k: run_sharded(torch, k, None) for k in SHARDED_RUNS}
    cfg, shape, _, _, _ = sharded_cell("decode")
    args = sharded_args(torch, "decode")
    with torch.no_grad():
        logits = steps.make_serve_step(build_model(cfg), cfg, logits=True)(
            *args)[2]
    del args
    decode_ref = plain["decode"][0] + (logits[:, -1:].float().cpu(),)
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group(MESH_BACKEND, init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            **({"device_id": torch.device(DEV, 0)}
                               if MESH_BACKEND == "nccl" else {}))
    one_window = PathWindow(torch)
    try:
        one = {}
        for k in SHARDED_RUNS:
            if k == "decode":
                one_window.start()
            one[k] = run_sharded(torch, k, init_device_mesh(
                DEV, (1, 1), mesh_dim_names=("data", "model")))
            if k == "decode":
                one_window.stop()
    finally:
        meshes.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    d = DRY_DIR / "sharded"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(SHARDED_RANKS), "--master-addr", "localhost", "--master-port",
           str(_free_port()), str(ROOT / "chip_smoke.py"), "--sharded-child",
           str(d)] + ran
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    with open(d / "torchrun.log", "w") as fh:
        proc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                              env=env, cwd=str(ROOT), timeout=300)
    ranks_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"sharded: the {SHARDED_RANKS}-rank run of {ran} exited "
             f"{proc.returncode}:\n{(d / 'torchrun.log').read_text()[-4000:]}")
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(SHARDED_RANKS)]
    out = {"ran": ran, "refused": refused, "seconds": ranks_s,
           "traced": traced, "ranks": ranks}
    for kind in ran:
        for r in ranks:
            if r[kind]["eager"] != traced[kind]["counts"]:
                fail(f"sharded {kind} rank {r['rank']}: CommDebugMode counts "
                     f"{r[kind]['eager']}, the trace "
                     f"{traced[kind]['counts']}")
        res = torch.load(d / f"{kind}.pt", weights_only=False)
        if kind == "decode":
            out[kind] = _compare_decode(torch, res, decode_ref,
                                        "decode, 2 ranks vs plain")
            continue
        m, m1, mp = res, one[kind][0], plain[kind][0]
        rel = {k: _rel(m[k], m1[k]) for k in ("loss", "gnorm")}
        rel_plain = {k: _rel(m1[k], mp[k]) for k in ("loss", "gnorm")}
        out[kind] = {"rel": rel, "rel_plain": rel_plain}
        if max(rel.values()) > SHARDED_LOSS_TOL or \
                max(rel_plain.values()) > SHARDED_LOSS_TOL:
            fail(f"sharded {kind}: loss/gnorm apart from the world of one by "
                 f"{rel}, the world of one from the plain program by "
                 f"{rel_plain} (tolerance {SHARDED_LOSS_TOL})")
        log(f"sharded: {SHARDED_RUNS[kind][0]} {kind} (float32, "
            f"{SHARDED_LAYERS} layers, {sharded_cell(kind)[1].seq_len} x "
            f"{sharded_cell(kind)[1].global_batch}) on {SHARDED_RANKS} "
            f"{ranks[0]['backend']} ranks of the card, mesh "
            f"{SHARDED_RUNS[kind][1]}: loss {float(m['loss']):.6f}, gnorm "
            f"{float(m['gnorm']):.6f}; relative to the world of one {rel}, "
            f"the world of one to the plain program {rel_plain}; rank "
            "seconds " + ", ".join(f"{r[kind]['seconds']:.2f}" for r in ranks)
            + f" (world of one {one[kind][3]:.2f}s, plain {plain[kind][3]:.2f}"
            f"s); collectives {traced[kind]['counts']} on each rank = the "
            f"trace's; peak " + ", ".join(
                f"{r[kind]['max_memory_allocated'] / 2**30:.2f}"
                for r in ranks) + " GiB")
    out["decode_one"] = _compare_decode(torch, one["decode"][0], decode_ref,
                                        "decode, world of one vs plain")
    k2 = one["decode"][2]
    if k2["dequant_matmul_w8"] == 0:
        fail(f"sharded decode: K2 not launched on the world of one's shard: "
             f"{k2}")
    for kind, kinds in refused.items():
        log(f"sharded: {SHARDED_RUNS[kind][0]} {kind} on "
            f"{SHARDED_RUNS[kind][1]}: its trace holds {kinds}, which gloo "
            "cannot carry on CUDA tensors; it ran at world 1 here "
            "(NCCL, a (1, 1) mesh), on 2 ranks on the CPU in "
            "tests/test_torch_sharded_cells.py")
    n, diff, near, over = out["decode_one"]
    log(f"sharded: smollm-135m decode ({SHARDED_LAYERS} layers, "
        f"{shape.seq_len} x {shape.global_batch}, int8) on an NCCL world of "
        f"one: {diff} of {n} tokens differ from the plain program's ({near} "
        f"near ties), cache difference {over:.3e} of its bound; "
        f"K2 {k2['dequant_matmul_w8']} launches on its shard, "
        f"{one['decode'][3]:.2f}s (plain {plain['decode'][3]:.2f}s); the "
        f"{SHARDED_RANKS}-rank run of {ran} took {ranks_s:.1f}s")
    window = PathWindow(torch)
    window.shapes |= one_window.shapes
    for r in ranks[:1]:
        for kind in ran:
            window.shapes |= {tuple(x) for x in r[kind].get("shapes", [])}
    rows.extend(check_path_shapes(torch, window, rows, "smollm-135m-sharded"))
    shutil.rmtree(d, ignore_errors=True)
    out["shard_rules"] = shard_rule_check(
        torch, sorted(s for s in one_window.shapes
                      if s[0] == "dequant_matmul_w8"))
    return k2, out


def shard_rule_check(torch, shapes, dev=DEV, backend="kernel"):
    """``kernels.ops._on_shards`` on the card: for each K2 shape (name, M,
    K, N, x dtype) in ``shapes``, a drawn int8 weight whose codes a (1, 2)
    mesh over a fake group of 2 splits on N and then on K (its scale and
    zero whole, for ``_held`` to cut), this process as rank 0 and then as
    rank 1. The rank's local product must be placed ``Shard(-1)`` (N) or
    ``Partial`` (K), launch K2 and agree with the plain version on the
    rank's halves: x @ W[:, half] and x[:, half] @ W[half]. These launches
    are no main path's. Returns the largest error over its tolerance."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.analysis.diffcheck import matmul_tol
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    if not shapes:
        fail("shard rules: the world of one's decode gave K2 no shape")
    worst, n_calls = 0.0, 0
    for rank in range(2):
        gen = torch.Generator(device=dev).manual_seed(5)
        with dryrun.fake_world(2, rank=rank):
            mesh = init_device_mesh(dev, (1, 2),
                                    mesh_dim_names=("data", "model"))
            for _, M, K, N, xd in shapes:
                x = torch.randn((M, K), generator=gen, device=dev).to(
                    getattr(torch, xd))
                codes = torch.randint(0, 256, (K, N), generator=gen,
                                      device=dev, dtype=torch.uint8)
                scale = torch.exp(torch.randn((1, N), generator=gen,
                                              device=dev) * 0.2) * 0.2 / 255
                zero = torch.round(torch.rand((1, N), generator=gen,
                                              device=dev) * 255)
                qt = QTensor(codes, scale, zero, (K, N), 8, False)
                for dim, placed in ((1, Shard(1)), (0, Partial())):
                    n = (N, K)[1 - dim] // 2
                    half = slice(rank * n, (rank + 1) * n)
                    local = (codes[:, half] if dim else codes[half])
                    dcodes = DTensor.from_local(
                        local.contiguous(), mesh, [Replicate(), Shard(dim)],
                        run_check=False, shape=codes.shape,
                        stride=codes.stride())
                    before = ops.dequant_matmul_w8.launches
                    got = ops.qtensor_matmul(
                        x, dataclasses.replace(qt, codes=dcodes),
                        backend=backend)
                    launched = ops.dequant_matmul_w8.launches - before
                    if dim:
                        xs, plain = x, QTensor(
                            local.contiguous(), scale[:, half],
                            zero[:, half], (K, n), 8, False)
                    else:
                        xs, plain = x[:, half].contiguous(), QTensor(
                            local.contiguous(), scale, zero, (n, N), 8,
                            False)
                    want = ops.qtensor_matmul(xs, plain, backend="torch")
                    where = (f"shard rules: K2 {M}x{K}x{N} {xd} split on "
                             f"{'NK'[1 - dim]}, rank {rank}")
                    if tuple(got.placements) != (Replicate(), placed) or \
                            (backend == "kernel" and launched != 1):
                        fail(f"{where}: placed {tuple(got.placements)}, "
                             f"{launched} K2 launches")
                    got = got.to_local()
                    w = None if x.dtype == torch.bfloat16 else \
                        plain.scale * (plain.codes.float() - plain.zero)
                    err = (got.float() - want.float()).abs()
                    tol = matmul_tol(xs, w, want, plain.shape[0])
                    if got.shape != want.shape or not bool((err <= tol).all()):
                        fail(f"{where}: shape {tuple(got.shape)}, max |err| "
                             f"{err.max().item():.3e} beyond the tolerance")
                    worst = max(worst, (err / tol).max().item())
                    n_calls += 1
    log(f"shard rules: {len(shapes)} K2 shapes of the decode, each split on "
        f"N and on K, on ranks 0 and 1 of a (1, 2) mesh: {n_calls} local "
        f"products placed as _on_shards says, each within its tolerance "
        f"(largest error {worst:.3f} of it)")
    return {"calls": n_calls, "worst_over_tol": worst}


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
    if len(sys.argv) > 2 and sys.argv[1] == "--mesh-child":
        return mesh_child(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "--moe-mesh-child":
        return moe_mesh_child(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "--analysis-mesh-child":
        return analysis_mesh_child(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "--dryrun-child":
        return dryrun_child(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "--sharded-child":
        return sharded_child(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "--sharded-trace-child":
        return sharded_trace_child(sys.argv[2])
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
    from repro_torch.roofline import analysis as roofline_peaks

    global PEAKS
    resolve_device()  # pins TF32 off for every float32 product below
    PEAKS = roofline_peaks.peaks(torch.cuda.get_device_name(0))
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
    dry_started = dryrun_start()  # (a) runs on the host from here on
    t0 = time.perf_counter()
    analysis = analysis_phase(torch)
    log(f"analysis phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts, path = path_phase(torch, np)
    analysis["smollm_path"] = path.pop("analysis")
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
    with children_paused():
        mesh_counts, mesh = mesh_phase(torch, np, rows)
    log(f"mesh phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    olmo_counts, olmo = olmo_phase(torch, np)
    log(f"olmo-1b launcher phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_counts, k4_counts, moe_path = moe_path_phase(torch, np)
    log(f"MoE path phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qwen_counts, qwen_path = path_phase(torch, np, "qwen2.5-14b", QWEN_LAYERS,
                                        (QWEN_LAYERS - 1,), "qwen")
    log(f"qwen2.5-14b path phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ds_counts, ds_path = deepseek_phase(torch, np)
    log(f"deepseek-v3 path phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wh_counts, wh_path = whisper_phase(torch, np, rows)
    log(f"whisper-medium path phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mb_counts, mb_path = mamba_phase(torch, np, rows)
    log(f"mamba2-130m launcher phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rg_counts, rg_path = hybrid_phase(torch, np, rows)
    log(f"recurrentgemma-2b launcher phase: {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = train_phase(torch, np)
    log(f"training phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss = loss_phase(torch, np)
    log(f"loss phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cells_counts, cells = cells_phase(torch, np, rows)
    log(f"cells phase: {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_counts, sharded = sharded_phase(torch, np, rows, dry_started)
    dry = dryrun_finish(dry_started)
    log(f"dry-run phase: {time.perf_counter() - t0:.1f}s")

    summary = []
    for name in KERNEL_NAMES:
        timed = _timed_row(rows, name)
        src, replaces = SOURCES[name]
        by_path = {"smollm-135m": counts[name],
                   "smollm-135m-trained": trained_counts[name],
                   "smollm-135m-auto-bits": auto_counts[name],
                   "smollm-135m-mesh": mesh_counts[name],
                   "olmo-1b-trained": olmo_counts[name],
                   "llama4-scout-17b-a16e": moe_counts[name],
                   "qwen2.5-14b": qwen_counts[name],
                   "deepseek-v3-671b": ds_counts[name],
                   "whisper-medium": wh_counts[name],
                   "mamba2-130m-trained": mb_counts[name],
                   "recurrentgemma-2b-trained": rg_counts[name],
                   "flexround_fake_quant": k4_counts[name],
                   "cells": cells_counts[name],
                   "smollm-135m-sharded": sharded_counts[name]}
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
         "analysis": analysis,
         "recon_graphs": recon_graphs, "trained_path": trained,
         "preemption": preemption, "auto_bits_path": auto_bits,
         "mesh_path": mesh,
         "olmo_path": olmo, "moe_path": moe_path, "qwen_path": qwen_path,
         "deepseek_path": ds_path, "whisper_path": wh_path,
         "mamba_path": mb_path, "recurrentgemma_path": rg_path,
         "training": training, "loss": loss, "cells": cells,
         "sharded": sharded, "dryrun": dry}, indent=1))
    log(smi)
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
