"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, head_dim 64, tied embeddings, a MoE FFN of 32 experts, top 8
a token [hf:ibm-granite/granite-3.0-1b-a400m-base].  As in the reference,
this is the repo's simplified transformer (RMSNorm, SwiGLU experts), not
the Hugging Face model.  SMOKE is the reference package's CPU test size of
the same architecture (4 experts, top 2)."""
from repro_torch.configs import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="granite-moe-1b-a400m",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64, tie_embeddings=True,
    moe=MoEConfig(num_experts=32, experts_per_token=8),
)

SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16, tie_embeddings=True,
    moe=MoEConfig(num_experts=4, experts_per_token=2),
)
