"""The assigned input-shape suite (applies to every architecture); a copy of
``repro/configs/shapes.py``.

  train_4k     seq 4,096   x batch 256   -> a training step
  prefill_32k  seq 32,768  x batch 32    -> prefill (serve)
  decode_32k   seq 32,768  x batch 128   -> one decode step over a cache of
                                            seq_len
  long_500k    seq 524,288 x batch 1     -> a decode step; ONLY for
                                            sub-quadratic archs (ssm/hybrid)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SHAPE_IDS = tuple(SHAPES)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cell_applicable(cfg, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) runs; the reason if it is skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""
