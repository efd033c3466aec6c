"""olmo_1b config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2402.00838; hf] — non-parametric LN
    name="olmo-1b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, norm="ln_nonparam", act="swiglu",
))
