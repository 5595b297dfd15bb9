"""Architecture config and the dense transformer: forward, prefill, decode.

Port of `repro/models/transformer.py`.  `ArchConfig` is the reference's,
field for field, with its block pattern (`period`, `layer_kind`).  The
model is an `nn.Module` holding `n_layers` blocks in order; layer `l` is
pattern position `l % period` of period `l // period`, the order of the
reference's scan over stacked per-position parameters.

Only attention mixers and the dense SwiGLU FFN are ported.  Building a
model whose pattern holds a mamba or rwkv mixer or an MoE FFN, or that
has a modality frontend, raises NotImplementedError naming its ROADMAP
item; so does `param_count` for such a config.  `forward` has no
rematerialisation and returns no MoE aux loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention, mlp
from repro_torch.models import modules as M

_NOT_PORTED = {
    "mamba": "the mamba mixer (models/mamba.py)",
    "rwkv": "the rwkv mixer (models/rwkv.py)",
    "moe": "the MoE FFN (models/moe.py)",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    # attention pattern
    window: Optional[int] = None   # sliding-window width for local layers
    local_ratio: int = 0           # N local layers per 1 global (gemma3: 5)
    # MoE
    moe_every: int = 0             # 0: none, 1: every layer, 2: alternate
    n_routed: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    n_padded: int = 0
    # hybrid (jamba)
    attn_every: int = 0            # one attention layer per this many
    d_state: int = 16
    # ssm
    rwkv: bool = False
    # modality frontend (stub: precomputed embeddings)
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    subquadratic: bool = False     # may run long_500k
    norm_eps: float = 1e-6

    # ------------------------------------------------------------ pattern

    @property
    def period(self) -> int:
        p = 1
        if self.local_ratio:
            p = self.local_ratio + 1
        if self.attn_every:
            p = max(p, self.attn_every)
        if self.moe_every:
            p = max(p, self.moe_every)
        assert self.n_layers % p == 0, (self.n_layers, p)
        return p

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def layer_kind(self, pos: int) -> Dict[str, Any]:
        """Block descriptor for pattern position `pos` (0..period-1)."""
        if self.rwkv:
            return {"mixer": "rwkv", "ffn": None}
        if self.attn_every:
            mixer = "attn" if pos == self.attn_every // 2 else "mamba"
        elif self.local_ratio:
            mixer = "attn_local" if pos < self.local_ratio else "attn"
        else:
            mixer = "attn_local" if self.window else "attn"
        if self.moe_every and (pos % self.moe_every == self.moe_every - 1):
            ffn = "moe"
        elif self.moe_every == 1:
            ffn = "moe"
        else:
            ffn = "mlp"
        return {"mixer": mixer, "ffn": ffn}

    # ------------------------------------------------------------ helpers

    def attn_args(self, local: bool) -> attention.AttnArgs:
        return attention.AttnArgs(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta,
            window=self.window if local else None)

    def check_ported(self) -> None:
        """Raise NotImplementedError unless every block of the pattern and
        the input path are ported."""
        if self.frontend:
            raise NotImplementedError(
                f"{self.name}: the {self.frontend} frontend (models/stubs.py) "
                f"is not ported yet (ROADMAP queue 1 item 11)")
        for pos in range(self.period):
            kind = self.layer_kind(pos)
            for part in (kind["mixer"], kind["ffn"]):
                if part in _NOT_PORTED:
                    raise NotImplementedError(
                        f"{self.name}: {_NOT_PORTED[part]} is not ported yet "
                        f"(ROADMAP queue 1 item 11)")

    def param_count(self) -> int:
        self.check_ported()
        n = 2 * self.vocab * self.d_model + self.d_model      # embed, head, ln_f
        for layer in range(self.n_layers):
            kind = self.layer_kind(layer % self.period)
            specs = {**attention.specs(self.attn_args(kind["mixer"] == "attn_local")),
                     **mlp.specs(self.d_model, self.d_ff)}
            n += 2 * self.d_model + sum(math.prod(s.shape) for s in specs.values())
        return n


# ------------------------------------------------------------------ model

def _pad_cache(kv: torch.Tensor, max_len: int) -> torch.Tensor:
    s = kv.shape[2]
    if s >= max_len:
        return kv[:, :, :max_len].contiguous()
    return F.pad(kv, (0, 0, 0, max_len - s))


class Block(nn.Module):
    """Pre-norm attention + SwiGLU block at pattern position `pos`."""

    def __init__(self, cfg: ArchConfig, pos: int, *, device, dtype, generator):
        super().__init__()
        self.eps = cfg.norm_eps
        ones = M.ParamSpec((cfg.d_model,), "ones")
        local = cfg.layer_kind(pos)["mixer"] == "attn_local"
        self.ln1 = M.param(ones, generator, device, dtype)
        self.attn = attention.Attention(cfg.attn_args(local), device=device,
                                        dtype=dtype, generator=generator)
        self.ln2 = M.param(ones, generator, device, dtype)
        self.mlp = mlp.MLP(cfg.d_model, cfg.d_ff, device=device, dtype=dtype,
                           generator=generator)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(M.rmsnorm(x, self.ln2, self.eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(M.rmsnorm(x, self.ln1, self.eps))
        return self._ffn(x)

    def prefill(self, x: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        y, kv = self.attn.apply_and_cache(M.rmsnorm(x, self.ln1, self.eps))
        cache = {k: _pad_cache(v, max_len) for k, v in kv.items()}
        return self._ffn(x + y), cache

    def decode_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        y, cache = self.attn.decode_step(M.rmsnorm(x, self.ln1, self.eps),
                                         cache, cache_len)
        return self._ffn(x + y), cache


class Transformer(nn.Module):
    """The dense LM of `cfg`, built on `device` (CUDA unless asked for the
    CPU).  With a `generator` the weights are drawn from it; without one
    they are left uninitialised for `load_state_dict`."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.check_ported()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed = M.param(M.ParamSpec((cfg.vocab, cfg.d_model), "normal", 0.02),
                             generator, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg, layer % cfg.period, **kw)
                                    for layer in range(cfg.n_layers))
        self.ln_f = M.param(M.ParamSpec((cfg.d_model,), "ones"), generator, device, dtype)
        self.head = M.param(M.dense_spec(cfg.d_model, cfg.vocab, scale=0.02),
                            generator, device, dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = M.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return M.dense(x, self.head).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] fp32."""
        x = self.embed[tokens]
        for block in self.blocks:
            x = block(x)
        return self._logits(x)

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16
                    ) -> List[Dict[str, torch.Tensor]]:
        """One zero KV cache [batch, Hkv, max_len, dh] per layer."""
        shape = (batch, self.cfg.n_kv_heads, max_len, self.cfg.d_head)
        dev = self.embed.device
        return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]], torch.Tensor]:
        """Prefill the caches with full prompts [B, S]; returns (last-token
        logits [B, V] fp32, per-layer caches padded to max_len, cache_len
        [B] int32)."""
        x = self.embed[tokens]
        caches = []
        for block in self.blocks:
            x, c = block.prefill(x, max_len)
            caches.append(c)
        b, s = tokens.shape
        cache_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return self._logits(x[:, -1]), caches, cache_len

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """token [B] -> (logits [B, V] fp32, caches updated in place).
        cache_len [B]: the filled length, the same for every layer."""
        x = self.embed[token][:, None, :]
        for block, c in zip(self.blocks, caches):
            x, _ = block.decode_step(x, c, cache_len)
        return self._logits(x[:, 0]), caches
