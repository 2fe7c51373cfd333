"""Tiny configs for tests and smoke runs (same registry names as the JAX
package's ``repro.configs.tiny``)."""
from repro_torch.configs.base import ModelConfig, dense_stack, register


@register("tiny-dense")
def tiny_dense() -> ModelConfig:
    return ModelConfig(
        name="tiny-dense", family="dense", d_model=64, vocab_size=512,
        stack=dense_stack(6), n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, mlp_act="silu", tie_embeddings=True, sub_quadratic=False,
        param_dtype="float32", compute_dtype="float32", max_seq_len=128,
    )


@register("tiny-gemma")
def tiny_gemma() -> ModelConfig:
    return tiny_dense().replace(
        name="tiny-gemma", stack=dense_stack(4, pattern=(32, None)),
        mlp_act="geglu", attn_logit_softcap=50.0, final_logit_softcap=30.0,
    )


@register("tiny-swa")
def tiny_swa() -> ModelConfig:
    return tiny_dense().replace(
        name="tiny-swa", stack=dense_stack(4, window=32), sub_quadratic=True)
