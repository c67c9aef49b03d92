"""whisper-medium [audio] — enc-dec, 24L+24L d_model=1024 16H d_ff=4096
vocab=51865; GELU+biases, LayerNorm, sinusoidal positions.  The conv audio
frontend is a stub, as in the reference: the caller provides precomputed
frame embeddings (B, 1500, d).  [arXiv:2212.04356]"""
from repro_torch.models.lm import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, enc_layers=24, enc_len=1500,
        d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=4096, vocab=51865, mlp_type="gelu", use_bias=True,
        norm_type="layernorm", pos_embedding="sinusoidal",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="whisper-medium-smoke", family="encdec",
        n_layers=3, enc_layers=3, enc_len=32,
        d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=512, vocab=512, mlp_type="gelu", use_bias=True,
        norm_type="layernorm", pos_embedding="sinusoidal",
        remat="none",
    )
