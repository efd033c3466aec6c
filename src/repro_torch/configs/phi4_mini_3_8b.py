"""phi4_mini_3_8b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2412.08905; hf] — RoPE SwiGLU GQA
    name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=8192, vocab=200064,
))
