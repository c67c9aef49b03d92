"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free, 64 wkv heads of
64) d_ff=14336 vocab=65536; data-dependent per-channel decay.
[arXiv:2404.05892; hf]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="rwkv6-7b", family="rwkv",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
        d_ff=14336, vocab=65536, rwkv_chunk=64,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="rwkv6-7b-smoke", family="rwkv",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=448, vocab=512,
        remat="none",
    )
