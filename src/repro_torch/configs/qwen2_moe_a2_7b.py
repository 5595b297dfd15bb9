"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4.

60 does not divide the 16-wide model axis: experts are padded to 64 with
router-masked dummies (n_padded) so expert-parallelism stays legal --
the divisibility fallback documented in DESIGN.md SSArch-applicability."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    moe_every=1, n_routed=60, top_k=4, n_shared=4, d_expert=1408,
    n_padded=64,
)
