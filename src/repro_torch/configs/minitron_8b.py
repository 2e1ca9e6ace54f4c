"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000, head_dim 128, tied embeddings — a pruned Nemotron
[arXiv:2407.14679; hf:nvidia/Minitron-8B-Base].  SMOKE is the reference
package's CPU test size of the same architecture (head_dim 16, G = 4)."""
from repro_torch.configs import TransformerConfig

FULL = TransformerConfig(
    name="minitron-8b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128, tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="minitron-8b-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, tie_embeddings=True,
)
