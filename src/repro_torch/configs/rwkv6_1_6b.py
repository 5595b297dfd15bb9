"""rwkv6-1.6b "Finch" [arXiv:2404.05892]: attention-free, data-dependent
decay linear recurrence.  O(1) decode state -> runs long_500k."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab=65536,
    rwkv=True,
    subquadratic=True,
)
