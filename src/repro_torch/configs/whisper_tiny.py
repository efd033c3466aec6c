"""whisper_tiny config (see configs/archs.py for the full assignment table)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    # [arXiv:2212.04356; unverified] — enc-dec, conv frontend stubbed
    name="whisper-tiny", n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, arch_kind="encdec", enc_layers=4, enc_len=1500,
    act="gelu",
))
