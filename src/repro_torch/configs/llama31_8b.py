"""Llama-3.1-8B [arXiv:2407.21783] -- one of the paper's own eval models
(DeepSeek-R1-Distill-Llama-8B shares its architecture).

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, dense_stack, register


@register("llama-3.1-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.1-8b",
        family="dense",
        d_model=4096,
        vocab_size=128_256,
        stack=dense_stack(32),
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        mlp_act="silu",
        rope_theta=500_000.0,
        tie_embeddings=False,
        param_dtype="bfloat16",
        sub_quadratic=False,
    )
