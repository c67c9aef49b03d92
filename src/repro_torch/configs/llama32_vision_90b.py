"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; a gated cross-attention layer over the vision tokens every
5th layer.  The vision tower is a stub, as in the reference: the caller
provides precomputed patch embeddings (B, 1024, d)."""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab=128256, mlp_type="swiglu", rope_theta=500000.0,
        cross_every=5, n_vision_tokens=1024,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm",
        n_layers=6, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=896, vocab=512, mlp_type="swiglu", rope_theta=500000.0,
        cross_every=3, n_vision_tokens=16,
        remat="none",
    )
