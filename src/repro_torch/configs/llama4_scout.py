"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, head_dim 128, untied embeddings, a MoE FFN of 16 experts,
top 1 a token [hf:meta-llama/Llama-4-Scout-17B-16E].  As in the reference,
this is the repo's simplified transformer (global attention on every
layer, no shared expert, no early fusion).  About 1.0e11 parameters: one
80 GB card holds its full width at a cut depth only.  SMOKE is the
reference package's CPU test size of the same architecture (G = 5, 4
experts)."""
from repro_torch.configs import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="llama4-scout-17b-a16e",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128, tie_embeddings=False,
    moe=MoEConfig(num_experts=16, experts_per_token=1),
)

SMOKE = TransformerConfig(
    name="llama4-scout-smoke",
    num_layers=2, d_model=80, num_heads=5, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=16, tie_embeddings=False,
    moe=MoEConfig(num_experts=4, experts_per_token=1),
)
