"""PyTorch + CUDA port of the FlexRound PTQ system (``repro``'s counterpart).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.flexround`` <-> ``repro.core.flexround``) and its
data layouts at public functions (weights ``(d_in, d_out)``, parameter trees
as plain dicts with the reference's keys, ``layers`` as a list of per-layer
dicts). It imports ``torch`` and never ``jax`` or anything of ``repro``.

Device policy (:mod:`repro_torch.device`): entry points take ``device=None``,
which means CUDA, and raise when no card is visible. Only an explicit
``device="cpu"`` runs on the CPU (the parity tests). The deploy-mode
quantized matmuls launch the hand-written kernels under ``csrc/`` for CUDA
tensors and their plain PyTorch versions for CPU tensors; nothing falls back
from one to the other.

Ported so far (see ROADMAP.md): FlexRound PTQ with its Adam loop and the
baseline methods for the dense, vlm and MoE decoders (smollm-135m,
granite-3-2b, qwen2.5-14b, olmo-1b, phi-3-vision-4.2b,
llama4-scout-17b-a16e), ``model.loss``, conv sites, automatic bit
allocation, the slot-based serving engine over the int8 KV cache with its
scheduler, and the launcher ``python -m repro_torch.launch.quantize`` with
its calibration data, per-block checkpoints and telemetry.
"""
