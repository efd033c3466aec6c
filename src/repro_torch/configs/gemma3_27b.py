"""gemma3_27b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k ctx
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144, head_dim=128,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, supports_long=True,   # 52/62 layers are window-1024
))
