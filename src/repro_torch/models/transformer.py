"""Architecture config and the model: forward, prefill, decode.

Port of `repro/models/transformer.py`.  `ArchConfig` is the reference's,
field for field, with its block pattern (`period`, `layer_kind`).  The
model is an `nn.Module` holding `n_layers` blocks in order; layer `l` is
pattern position `l % period` of period `l // period`, the order of the
reference's scan over stacked per-position parameters.  A block is what
`layer_kind` says: an RWKV block (its own norms inside), or a pre-norm
attention or mamba mixer followed by an MoE or a dense SwiGLU FFN.

`forward` and `prefill` take optional `frontend_embeds` [B, F, d] (the
llava / musicgen stubs, `models/stubs.py`), prepended to the token
embeddings as the reference's `_embed_inputs` does.  The per-layer
serving state is the KV cache of an attention layer, the conv window and
SSM state of a mamba layer, or the WKV state of an RWKV block.

`forward` is the training pass: it returns (logits, the MoE layers'
summed aux loss) and, with `remat` (the default) and autograd on,
rematerialises each period of `period` layers
(`torch.utils.checkpoint`, non-reentrant), as the reference's
`jax.checkpoint(period_fn)` does: a period keeps only its input for the
backward pass and runs again inside it, so every attention layer launches
its forward kernel twice a training step.  The reference's
`REPRO_REMAT_POLICY=dots` lever (keep the matmuls' outputs) is left out.
`loss_fn` is the training loss.  Serving (`prefill`, `decode_step`) skips
the aux term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention, mamba, mlp, moe, rwkv
from repro_torch.models import modules as M
from repro_torch.sharding import logical


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

    def moe_args(self) -> moe.MoEArgs:
        return moe.MoEArgs(
            d_model=self.d_model, n_routed=self.n_routed, top_k=self.top_k,
            d_expert=self.d_expert, n_shared=self.n_shared,
            n_padded=self.n_padded)

    def mamba_args(self) -> mamba.MambaArgs:
        return mamba.MambaArgs(d_model=self.d_model, d_state=self.d_state)

    def rwkv_args(self) -> rwkv.RWKVArgs:
        return rwkv.RWKVArgs(d_model=self.d_model, d_ff=self.d_ff)

    def param_count(self) -> int:
        """The reference's count: one period's blocks built without storage
        (device "meta") times the periods, plus embed, head and ln_f."""
        blocks = sum(p.numel() for pos in range(self.period)
                     for p in Block(self, pos, device="meta", dtype=torch.float32,
                                    generator=None).parameters())
        return blocks * self.n_periods + 2 * self.vocab * self.d_model + self.d_model


# ------------------------------------------------------------------ model

class Block(nn.Module):
    """The block at pattern position `pos`: RWKV (its own channel-mix FFN),
    or pre-norm attention / mamba followed by a pre-norm MoE or SwiGLU."""

    def __init__(self, cfg: ArchConfig, pos: int, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        kind = cfg.layer_kind(pos)
        self.mixer, self.ffn = kind["mixer"], kind["ffn"]
        kw = dict(device=device, dtype=dtype, generator=generator)
        if self.mixer == "rwkv":
            self.rwkv = rwkv.RWKV(cfg.rwkv_args(), **kw)
            return
        ones = M.ParamSpec((cfg.d_model,), "ones", axes=("embed",))
        M.put(self, "ln1", ones, generator, device, dtype)
        if self.mixer == "mamba":
            self.mamba = mamba.Mamba(cfg.mamba_args(), **kw)
        else:
            self.attn = attention.Attention(cfg.attn_args(self.mixer == "attn_local"), **kw)
        M.put(self, "ln2", ones, generator, device, dtype)
        if self.ffn == "moe":
            self.moe = moe.MoE(cfg.moe_args(), **kw)
        elif self.ffn == "mlp":
            self.mlp = mlp.MLP(cfg.d_model, cfg.d_ff, **kw)

    def _ffn(self, x: torch.Tensor, aux: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + the FFN of norm2(x), and the MoE aux term if `aux` (0 without
        MoE; None unless `aux`)."""
        h = M.rmsnorm(x, self.ln2, self.cfg.norm_eps)
        if self.ffn == "moe":
            y, a = self.moe(h, aux=aux)
            return x + y, a
        return x + self.mlp(h), torch.zeros((), device=x.device) if aux else None

    def _norm1(self, x: torch.Tensor) -> torch.Tensor:
        return M.rmsnorm(x, self.ln1, self.cfg.norm_eps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-sequence block (training): (x, its MoE aux loss, 0 for
        a block without MoE)."""
        if self.mixer == "rwkv":
            state = rwkv.init_state(self.cfg.rwkv_args(), x.shape[0], x.device)
            return self.rwkv(x, state)[0], torch.zeros((), device=x.device)
        mixer = self.mamba if self.mixer == "mamba" else self.attn
        return self._ffn(x + mixer(self._norm1(x)), aux=True)

    def prefill(self, x: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.mixer == "rwkv":
            return self.rwkv(x, rwkv.init_state(self.cfg.rwkv_args(), x.shape[0], x.device))
        if self.mixer == "mamba":
            y, cache = self.mamba.apply_and_cache(self._norm1(x))
        else:
            y, cache = self.attn.apply_and_cache(self._norm1(x), max_len)
        return self._ffn(x + y)[0], cache

    def decode_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.mixer == "rwkv":
            return self.rwkv(x, cache)
        if self.mixer == "mamba":
            y, cache = self.mamba.decode_step(self._norm1(x), cache)
        else:
            y, cache = self.attn.decode_step(self._norm1(x), cache, cache_len)
        return self._ffn(x + y)[0], cache


class Transformer(nn.Module):
    """The LM of `cfg`, built on `device` (CUDA unless asked for the CPU).
    With a `generator` the weights are drawn from it; without one they are
    left uninitialised for `load_state_dict`."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        M.put(self, "embed", M.ParamSpec((cfg.vocab, cfg.d_model), "normal", 0.02,
                                         ("vocab", "embed")), generator, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg, layer % cfg.period, **kw)
                                    for layer in range(cfg.n_layers))
        M.put(self, "ln_f", M.ParamSpec((cfg.d_model,), "ones", axes=("embed",)),
              generator, device, dtype)
        M.put(self, "head", M.dense_spec(cfg.d_model, cfg.vocab, scale=0.02,
                                         axes=("embed", "vocab")), generator, device, dtype)

    def _embed(self, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if (logical.current() is not None and isinstance(self.embed, DTensor)
                and not isinstance(tokens, DTensor)):
            # tokens every rank holds whole: take this rank's batch rows, so
            # the masked partial rows below carry a mask of their own shape
            # (DTensor splits the rows by batch before it applies the mask)
            tokens = distribute_tensor(tokens, *logical.named_sharding(("batch", "seq"),
                                                                       tokens.shape),
                                       src_data_rank=None)
        tokens = logical.constrain(tokens, "batch", "seq")
        # F.embedding, not indexing: its backward sums each row's gradients
        # in a fixed order, where index_put's accumulation adds with atomics
        x = F.embedding(tokens, self.embed)
        if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
            # a vocab-sharded table gives masked partial rows: reduce them
            # here, and have their gradient arrive in the reduced layout
            # (DTensor cannot turn a summed-partial gradient back into a
            # masked one)
            x = logical.constrain(x, "batch", "seq", "embed")
            x = DTensor.from_local(x.to_local(grad_placements=x.placements), x.device_mesh,
                                   x.placements, run_check=False)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        return logical.constrain(x, "batch", "seq", "embed")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = M.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return M.dense(x, self.head).float()

    def _period(self, x: torch.Tensor, first: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The `period` layers from layer `first` on: (x, their summed aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks[first:first + self.cfg.period]:
            x, a = block(x)
            aux = aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None, remat: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] (after frontend_embeds [B, F, d], if given) ->
        (logits [B, F + S, V] fp32, the MoE aux loss summed over layers).
        With `remat` and autograd on, each period is rematerialised."""
        x = self._embed(tokens, frontend_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for first in range(0, self.cfg.n_layers, self.cfg.period):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(self._period, x, first, use_reentrant=False)
            else:
                x, a = self._period(x, first)
            aux = aux + a
        return logical.constrain(self._logits(x), "batch", "seq", "vocab"), aux

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16
                    ) -> List[Dict[str, torch.Tensor]]:
        """Per layer, zero serving state: a KV cache [batch, Hkv, max_len,
        dh] in `dtype`, a mamba cache (conv window in `dtype`, SSM state
        fp32) or an RWKV state (fp32)."""
        cfg, dev = self.cfg, self.embed.device
        shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
        caches = []
        for block in self.blocks:
            if block.mixer == "rwkv":
                caches.append(rwkv.init_state(cfg.rwkv_args(), batch, dev))
            elif block.mixer == "mamba":
                caches.append(mamba.init_cache(cfg.mamba_args(), batch, dtype, dev))
            else:
                caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                               "v": torch.zeros(shape, dtype=dtype, device=dev)})
        return caches

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]], torch.Tensor]:
        """Prefill the serving state with full prompts [B, S]; returns
        (last-token logits [B, V] fp32, per-layer state with KV caches
        padded to max_len, cache_len [B] int32 counting frontend tokens)."""
        x = self._embed(tokens, frontend_embeds)
        caches = []
        for block in self.blocks:
            x, c = block.prefill(x, max_len)
            caches.append(c)
        b, s = x.shape[:2]
        cache_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return self._logits(x[:, -1]), caches, cache_len

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """token [B] -> (logits [B, V] fp32, the updated per-layer state; KV
        caches are written in place).  cache_len [B]: the filled length,
        the same for every layer."""
        x = self._embed(token[:, None], None)
        new = []
        for block, c in zip(self.blocks, caches):
            x, c = block.decode_step(x, c, cache_len)
            new.append(c)
        return self._logits(x[:, 0]), new


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B, S], targets [B, S] (+ frontend_embeds [B, F, d],
    an optional mask [B, S]) -> (xent + aux, {"xent", "aux"}).  The
    frontend positions' logits are sliced off before the loss."""
    fe = batch.get("frontend_embeds")
    logits, aux = model(batch["tokens"], fe)
    f = 0 if fe is None else fe.shape[1]
    xent = M.softmax_xent(logits[:, f:, :], batch["targets"], batch.get("mask"))
    return xent + aux, {"xent": xent, "aux": aux}


def param_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of every parameter of `model`, by its name in
    `named_parameters`, as its module's specs declare them."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, axes in mod.__dict__.get("_axes", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = axes
    return {n: out[n] for n, _ in model.named_parameters()}
