"""llama3_2_1b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [hf:meta-llama/Llama-3.2-1B; unverified]
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500_000.0,
))
