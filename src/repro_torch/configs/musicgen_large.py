"""musicgen-large [arXiv:2306.05284; hf]: decoder-only LM over EnCodec
tokens; the EnCodec frontend is a stub supplying frame embeddings."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    frontend="audio", n_frontend_tokens=250,
)
