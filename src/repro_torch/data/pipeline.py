"""Data pipeline: synthetic token streams + calibration sets (port of
``repro/data/pipeline.py``).

The paper's PTQ needs only a small calibration sample; both it and the
token stream are built on a counter-based draw, so any host can materialize
exactly its shard for any step:

    batch(step, host, n_hosts) is a pure function.

Each shard's draws come from a CPU ``torch.Generator`` seeded from
``(seed, step, host)``, so a seed gives the same tokens whether the run is on
the CPU or the card. The stream is not the reference's (that one is JAX's
threefry); tests that need the reference's tokens pass them in.

Straggler mitigation: ``assemble_global_batch`` takes per-host fetch results;
missing shards are zero-filled and masked out of the loss by a per-sample
weight (the policy and its errors are the reference's, in numpy).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _generator(seed: int, step: int, host: int) -> torch.Generator:
    """A CPU generator whose seed is a digest of ``(seed, step, host)``."""
    h = hashlib.sha256(f"{seed},{step},{host}".encode()).digest()
    gen = torch.Generator()
    gen.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return gen


class SyntheticTokens:
    """Markov-ish synthetic corpus: learnable but non-trivial structure.

    Tokens follow the reference's closed form of an affine recurrence,
    ``t_i = (t0 * a^i + b * i + sum_{j<=i} noise_j) mod V``, with per-sequence
    ``a`` in [1, n_modes], ``b`` and ``t0`` in [0, V) and noise in {0, 1, 2}:
    a model must use context to predict. ``a^i`` is taken mod V exactly
    (the reference computes it in int32, which wraps for long sequences).
    """

    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 n_modes: int = 8):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        self.n_modes = n_modes

    def _draws(self, step: int, local: int, host: int):
        """(a, b, t0, noise) of one shard: (local, 1) x 3 and
        (local, seq_len + 1), int64."""
        gen = _generator(self.seed, step, host)
        a = torch.randint(1, self.n_modes + 1, (local, 1), generator=gen)
        b = torch.randint(0, self.vocab, (local, 1), generator=gen)
        t0 = torch.randint(0, self.vocab, (local, 1), generator=gen)
        noise = torch.randint(0, 3, (local, self.seq_len + 1), generator=gen)
        return a, b, t0, noise

    def batch(self, step: int, batch_size: int, host: int = 0,
              n_hosts: int = 1) -> Dict[str, torch.Tensor]:
        """Deterministic global batch shard for (step, host): int64 CPU
        ``tokens`` and ``labels`` (the tokens shifted by one), each
        (batch_size / n_hosts, seq_len)."""
        if n_hosts < 1 or not 0 <= host < n_hosts:
            raise ValueError(
                f"host index {host} out of range for n_hosts={n_hosts}")
        if batch_size % n_hosts:
            raise ValueError(
                f"global batch_size={batch_size} does not divide over "
                f"n_hosts={n_hosts} (per-host shards must be equal-sized; "
                f"got remainder {batch_size % n_hosts})")
        local = batch_size // n_hosts
        V = self.vocab
        a, b, t0, noise = self._draws(step, local, host)
        powers = torch.ones((local, self.seq_len + 1), dtype=torch.int64)
        for i in range(1, self.seq_len + 1):
            powers[:, i] = powers[:, i - 1] * a[:, 0] % V
        idx = torch.arange(self.seq_len + 1)[None, :]
        toks = (t0 * powers + b * idx + torch.cumsum(noise, dim=1)) % V
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class CalibrationSet:
    """The paper's calibration sample: N sequences from the 'training
    distribution' (synthetic here), fixed once per PTQ run."""

    tokens: torch.Tensor  # (N, S)

    @staticmethod
    def build(source: SyntheticTokens, n_samples: int) -> "CalibrationSet":
        """The reference's chunking: steps 10,000 + i, a quarter of the
        set (at least one sequence) per step."""
        per = max(1, n_samples // 4)
        batches = [source.batch(10_000 + i, per)["tokens"]
                   for i in range((n_samples + per - 1) // per)]
        return CalibrationSet(tokens=torch.cat(batches, dim=0)[:n_samples])

    @staticmethod
    def build_sharded(source: SyntheticTokens, n_samples: int, n_hosts: int,
                      policy: Optional["StragglerPolicy"] = None,
                      drop_hosts: Sequence[int] = (),
                      ) -> Tuple["CalibrationSet", torch.Tensor]:
        """Per-host calibration assembly: each host materializes exactly its
        shard of step 10,000 and the shards combine through the straggler
        policy. Returns ``(calibration_set, weight)``, ``weight`` the (N,)
        per-sample loss mask (0 for samples of dropped hosts).
        ``drop_hosts`` simulates hosts that missed the deadline."""
        shards: List[Optional[Dict[str, np.ndarray]]] = []
        for h in range(n_hosts):
            if h in drop_hosts:
                shards.append(None)
                continue
            shard = source.batch(10_000, n_samples, host=h, n_hosts=n_hosts)
            shards.append({k: v.numpy() for k, v in shard.items()})
        batch, weight = assemble_global_batch(
            shards, policy or StragglerPolicy())
        return CalibrationSet(tokens=batch["tokens"]), weight

    def __len__(self):
        return int(self.tokens.shape[0])


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Deadline-based shard dropping for global batch assembly."""

    deadline_ms: float = 100.0
    min_fraction: float = 0.75  # below this, wait anyway (quality floor)


def assemble_global_batch(shards: Sequence[Optional[Dict[str, np.ndarray]]],
                          policy: StragglerPolicy
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Combine per-host shards; None = host missed the deadline.

    Returns (batch, weight): missing shards are zero-filled and ``weight``
    (B,) float32 masks them out, so a weighted mean of the loss stays
    unbiased. Shards must agree in keys and shapes (a ValueError names the
    host that does not)."""
    present = [s for s in shards if s is not None]
    if not present:
        raise RuntimeError("all shards missed the deadline")
    frac = len(present) / len(shards)
    if frac < policy.min_fraction:
        raise TimeoutError(
            f"only {frac:.0%} of shards arrived (< {policy.min_fraction:.0%})")
    proto_host = next(h for h, s in enumerate(shards) if s is not None)
    proto = shards[proto_host]
    for h, s in enumerate(shards):
        if s is None:
            continue
        if set(s) != set(proto):
            raise ValueError(
                f"host {h} shard keys {sorted(s)} do not match host "
                f"{proto_host}'s {sorted(proto)}")
        for k in proto:
            if np.shape(s[k]) != np.shape(proto[k]):
                raise ValueError(
                    f"host {h} shard {k!r} has shape {np.shape(s[k])} but "
                    f"host {proto_host} has {np.shape(proto[k])}; per-host "
                    "shards must be equal-sized")
    out: Dict[str, List[np.ndarray]] = {k: [] for k in proto}
    weights = []
    for s in shards:
        use = s if s is not None else {k: np.zeros_like(v)
                                       for k, v in proto.items()}
        for k in proto:
            out[k].append(np.asarray(use[k]))
        weights.append(np.full((np.shape(proto["tokens"])[0],),
                               0.0 if s is None else 1.0, np.float32))
    batch = {k: torch.from_numpy(np.concatenate(vs, axis=0))
             for k, vs in out.items()}
    return batch, torch.from_numpy(np.concatenate(weights))
