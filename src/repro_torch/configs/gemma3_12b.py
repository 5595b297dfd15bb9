"""gemma3-12b [hf:google/gemma-3 family]: 5:1 local:global attention,
sliding window 1024, 128k context.  Sub-quadratic locals -> runs long_500k
(the 1-in-6 global layers hold full KV; decode stays linear)."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=15360, vocab=262144,
    window=1024, local_ratio=5, rope_theta=1_000_000.0,
    subquadratic=True,
)
