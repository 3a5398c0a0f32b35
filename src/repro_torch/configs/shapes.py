"""Assigned input shapes and their stand-ins (port of
``repro.configs.shapes``).

LM transformer shapes are seq_len x global_batch.  ``decode_*`` /
``long_*`` run the decode step (one new token against a cache of
seq_len), NOT the train step; ``train_*`` runs the training step;
``prefill_*`` the prefill.  ``input_specs`` returns the data inputs as
tensors on the ``meta`` device (shape and dtype, no storage), as the
reference returns ``jax.ShapeDtypeStruct``s; ``launch.dryrun`` builds the
parameters, optimizer state and cache on the meta device from the model
itself, so they always match the real trees.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def input_specs(cfg: ArchConfig, shape: Shape,
                device="meta") -> dict[str, torch.Tensor]:
    """Data-input stand-ins for one (arch x shape) cell: int32 ids, or
    bf16 frame embeddings where ``cfg.input_kind == "embeds"``."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    embeds = cfg.input_kind == "embeds"      # modality-frontend stub
    if shape.kind == "train":
        return {"inputs": spec((b, s, cfg.d_model), torch.bfloat16)
                if embeds else spec((b, s)),
                "labels": spec((b, s))}
    if shape.kind == "prefill":
        return {"inputs": spec((b, s, cfg.d_model), torch.bfloat16)
                if embeds else spec((b, s))}
    if shape.kind == "decode":
        return {"tokens": spec((b,)), "positions": spec((b,))}
    raise ValueError(shape.kind)


def runnable_cells(cfg: ArchConfig) -> list[Shape]:
    """Shapes this arch runs; mandated skips documented in cfg.skip_shapes."""
    return [s for s in SHAPES.values() if s.name not in cfg.skip_shapes]
