"""Model/config system.

Every assigned architecture is a :class:`ModelConfig`; layer layout is a
repeating ``pattern`` of layer kinds (cycled over ``n_layers``):

  * ``global`` — full causal (or bidirectional for encoders) attention
  * ``local``  — sliding-window attention (``window`` tokens)
  * ``rglru``  — Griffin RG-LRU recurrent block (+ temporal conv)
  * ``ssd``    — Mamba-2 state-space duality block

Each layer is followed by its FFN (dense SwiGLU/GELU or MoE per
``moe``), except ``rglru``/``ssd`` blocks which carry their own mixing
and still get the FFN (Griffin/Mamba block structure handled in
models/transformer.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None               # for "local" layers
    moe: Optional[MoEConfig] = None
    arch_kind: str = "decoder"                 # decoder | encdec | vlm
    norm: str = "rms"                          # rms | ln_nonparam
    act: str = "swiglu"                        # swiglu | gelu
    rope_theta: float = 10_000.0
    # recurrent blocks
    ssd_state: int = 128                       # mamba2 N
    ssd_head_dim: int = 64                     # mamba2 P
    ssd_expand: int = 2
    rglru_conv: int = 4
    # enc-dec / vlm stubs
    enc_layers: int = 0
    enc_len: int = 1536                        # stub frame/patch count
    img_tokens: int = 0                        # vlm: prepended patch embeds
    # serving
    page_size: int = 64
    # numerics
    dtype: str = "bfloat16"
    # which shapes are runnable (sub-quadratic rule; see DESIGN.md)
    supports_long: bool = False
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype of activations, weights and KV pages (the
        counterpart of the JAX package's ``jdtype``)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of each of the n_layers layers (pattern cycled)."""
        pat = self.pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def n_attn_layers(self) -> int:
        return sum(1 for k in self.layer_kinds
                   if base_kind(k) in ("global", "local"))

    @property
    def n_groups(self) -> int:
        """Full pattern repetitions (the scan length)."""
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[str, ...]:
        """Layer kinds after the last full pattern group (unrolled)."""
        return self.layer_kinds[self.n_groups * len(self.pattern):]

    

def base_kind(kind: str) -> str:
    """Strip the ffn marker: "global_moe" -> "global"."""
    return kind[:-4] if kind.endswith("_moe") else kind


def is_moe_kind(kind: str) -> bool:
    return kind.endswith("_moe")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str           # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import archs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def list_archs():
    from . import archs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, 2 * len(cfg.pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        window=min(cfg.window, 32) if cfg.window else None,
        moe=MoEConfig(4, cfg.moe.top_k, cfg.moe.capacity_factor) if cfg.moe else None,
        ssd_state=16,
        ssd_head_dim=16,
        enc_layers=min(cfg.enc_layers, 2),
        enc_len=24,
        img_tokens=min(cfg.img_tokens, 8),
        page_size=8,
        dtype="float32",
    )
    base = dataclasses.asdict(cfg)
    base.update(kw)
    base["moe"] = kw["moe"]
    return ModelConfig(**base)
