"""jamba-v0.1-52b [arXiv:2403.19887; hf]: Mamba+attention 1:7 interleave,
MoE 16e top-2 on alternate layers.  SSM layers keep O(1) decode state ->
runs long_500k."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=65536,
    attn_every=8, moe_every=2, n_routed=16, top_k=2, d_expert=14336,
    n_padded=16, d_state=16,
    subquadratic=True,
)
