"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, head_dim 256, tied embeddings, rope_theta 1e6 — five
sliding-window layers (512 positions) to one global, cycled ("LLLLLG")
[hf:google/gemma-3-1b-pt].

As in the reference, this is the simplified transformer every config of
the repo runs (RMSNorm, SwiGLU, one ``rope_theta`` for every layer, no
QK-norm), not the Hugging Face model.  SMOKE is the reference package's
CPU test size of the same architecture (head_dim 32, window 128)."""
from repro_torch.configs import TransformerConfig

FULL = TransformerConfig(
    name="gemma3-1b",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    attn_pattern="LLLLLG", local_window=512, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="gemma3-1b-smoke",
    num_layers=6, d_model=96, num_heads=4, num_kv_heads=1,
    d_ff=192, vocab_size=512, head_dim=32,
    attn_pattern="LLLLLG", local_window=128, tie_embeddings=True,
)
