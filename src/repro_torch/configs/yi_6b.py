"""yi-6b [arXiv:2403.04652; hf]: llama-arch GQA with 4 KV heads."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab=64000,
)
