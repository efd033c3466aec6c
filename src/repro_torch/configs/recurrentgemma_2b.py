"""recurrentgemma_2b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2402.19427; hf] — RG-LRU + local attn, pattern 2 rec : 1 attn
    name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
    n_kv_heads=1, d_ff=7680, vocab=256000,
    pattern=("rglru", "rglru", "local"), window=2048, act="gelu",
    supports_long=True,
))
