"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE, 2 shared +
64 routed top-6 experts per layer."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=102400,
    moe_every=1, n_routed=64, top_k=6, n_shared=2, d_expert=1408,
    n_padded=64,
)
