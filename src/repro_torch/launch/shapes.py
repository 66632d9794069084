"""The assigned input-shape grid and abstract input specs (no allocation);
the JAX package's `repro.launch.shapes`.

Four shapes per LM architecture:
    train_4k     seq 4096,    global_batch 256   -> train step
    prefill_32k  seq 32768,   global_batch 32    -> prefill
    decode_32k   seq 32768,   global_batch 128   -> decode step (KV @ 32k)
    long_500k    seq 524288,  global_batch 1     -> decode step (KV @ 512k)

long_500k is only valid for sub-quadratic archs (ssm / hybrid / gemma3's
5:1 sliding-window pattern); `cell_supported` encodes the skip rule.

`input_specs` gives meta tensors (JAX's `ShapeDtypeStruct`s), of JAX's
shapes and dtypes (int32 token ids), each with its `NamedSharding` under
the active mesh (None without one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 512k decode has no "
                       "sub-quadratic path")
    return True, ""


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """A model input: its meta tensor and its sharding under the active
    mesh (None without one)."""
    tensor: torch.Tensor
    sharding: Optional[SH.NamedSharding]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype


def _spec(shape, dtype, *axes) -> InputSpec:
    return InputSpec(torch.empty(shape, dtype=dtype, device="meta"),
                     SH.named_sharding(axes, shape))


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, InputSpec]:
    """Stand-ins for every model input of this cell.

    For train: the batch dict. For prefill: prompt tokens (+modality
    stubs).  For decode: the one-token batch (the KV cache is built
    separately).
    """
    b, s = shape.global_batch, shape.seq_len
    ids = torch.int32
    if shape.kind == "train":
        d = {"tokens": _spec((b, s), ids, "batch", None),
             "labels": _spec((b, s), ids, "batch", None)}
    elif shape.kind == "prefill":
        d = {"tokens": _spec((b, s), ids, "batch", None)}
    else:  # decode
        d = {"tokens": _spec((b, 1), ids, "batch", None)}
    if cfg.family == "audio" and shape.kind != "decode":
        d["frames"] = _spec((b, cfg.enc_seq, cfg.d_model), torch.float32,
                            "batch", None, "act_embed")
    if cfg.family == "vlm" and shape.kind != "decode":
        d["patches"] = _spec((b, cfg.n_patches, cfg.d_model), torch.float32,
                             "batch", None, "act_embed")
    return d
