"""mamba2_370m config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2405.21060; unverified] — SSD, attention-free
    name="mamba2-370m", n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, pattern=("ssd",), ssd_state=128, ssd_head_dim=64,
    supports_long=True,
))
