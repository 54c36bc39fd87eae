"""The four assigned input shapes, a copy of ``repro.configs.shapes``.

``decode_*`` / ``long_*`` are one token against a seq_len cache
(``decode_step``), not a train step; ``models.api.input_specs`` gives
each shape's inputs on the meta device."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k requires sub-quadratic attention (run for ssm/hybrid only).
LONG_OK_FAMILIES = ("ssm", "hybrid")


def shapes_for(family: str):
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if family in LONG_OK_FAMILIES:
        out.append("long_500k")
    return out
