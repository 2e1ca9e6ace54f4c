"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000, head_dim 128, untied embeddings — llama-arch GQA with global
attention on every layer [arXiv:2403.04652; hf:01-ai/Yi-6B].  rope_theta
is the reference's default (10000), as the reference config sets no other.
SMOKE is the reference package's CPU test size of the same architecture
(head_dim 16, G = 8)."""
from repro_torch.configs import TransformerConfig

FULL = TransformerConfig(
    name="yi-6b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128, tie_embeddings=False,
)

SMOKE = TransformerConfig(
    name="yi-6b-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=16, tie_embeddings=False,
)
