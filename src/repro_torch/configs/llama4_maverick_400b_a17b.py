"""llama4_maverick_400b_a17b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    # [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE 128e top-1
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, pattern=("global_moe", "global"),
    moe=MoEConfig(num_experts=128, top_k=1),
))
