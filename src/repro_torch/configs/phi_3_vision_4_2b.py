"""phi_3_vision_4_2b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [hf:microsoft/Phi-3-vision-128k-instruct; hf] — phi3-mini + CLIP stub
    name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, arch_kind="vlm",
    img_tokens=576,   # stubbed CLIP patch embeddings, provided as input
))
