"""mixtral_8x7b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2401.04088; hf] — 8 experts top-2, SWA
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, pattern=("local_moe",), window=4096,
    moe=MoEConfig(num_experts=8, top_k=2), supports_long=True,  # SWA bounds KV
))
