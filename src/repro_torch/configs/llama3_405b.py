"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, RoPE theta 5e5.  [arXiv:2407.21783; unverified]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama3-405b", family="decoder",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
        d_ff=53248, vocab=128256, mlp_type="swiglu", rope_theta=500000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama3-405b-smoke", family="decoder",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=832, vocab=512, mlp_type="swiglu", rope_theta=500000.0,
        remat="none",
    )
