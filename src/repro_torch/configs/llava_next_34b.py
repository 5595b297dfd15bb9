"""llava-next-34b [hf:llava-hf line]: VLM backbone; anyres vision tower is a
stub supplying patch embeddings (models/stubs.py).  56 heads do not divide
the 16-wide model axis -> the rules engine shards the flattened head dim
(56*128 = 7168 divides) and lets sequence sharding carry attention."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    frontend="vision", n_frontend_tokens=576,
)
