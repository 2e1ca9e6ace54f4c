"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, head_dim 64, tied embeddings — llama-arch small
[hf:HuggingFaceTB/SmolLM-135M].  SMOKE is the reference package's CPU test
size of the same architecture."""
from repro_torch.configs import TransformerConfig

FULL = TransformerConfig(
    name="smollm-135m",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64, tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="smollm-135m-smoke",
    num_layers=2, d_model=96, num_heads=3, num_kv_heads=1,
    d_ff=192, vocab_size=512, head_dim=32, tie_embeddings=True,
)
