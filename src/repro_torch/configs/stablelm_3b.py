"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b", family="decoder",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
        d_ff=6912, vocab=50304, mlp_type="swiglu", rope_theta=10000.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b-smoke", family="decoder",
        n_layers=4, d_model=160, n_heads=4, n_kv_heads=4, d_head=40,
        d_ff=432, vocab=512, mlp_type="swiglu", rope_theta=10000.0,
        remat="none",
    )
