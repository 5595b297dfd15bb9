"""granite-8b [arXiv:2405.04324; hf]: llama-arch code model."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=49152,
)
