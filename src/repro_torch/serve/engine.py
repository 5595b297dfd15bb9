"""Batched serving engine: slot-based continuous batching over fixed caches.

Port of `repro/serve/engine.py`.  A fixed pool of `n_slots` rows of
serving state -- per layer, KV rows for attention, the conv window and
SSM state for mamba, the WKV state for RWKV -- is shared by all in-flight
requests:

  submit()  -> pick a free slot, prefill the prompt (batch 1) into it,
               each leaf cast to the pool's dtype (RWKV's token-shift
               carries come out of a prefill in the model's dtype and sit
               in an fp32 pool, as in the reference)
  step()    -> one decode for the whole pool; inactive slots are masked
  finished  -> slot freed (eos, per-request max_new, or a full cache)

The bookkeeping (active slots, cache lengths, pending tokens) lives on the
host; each step hands the model a copy of the cache lengths.  Sampling is
greedy at temperature 0 and otherwise draws from the softmax with the
engine's own `torch.Generator` (the reference draws with a JAX key, so the
sampled tokens differ; greedy tokens do not).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class Engine:
    def __init__(self, model: Transformer, n_slots: int, max_len: int,
                 eos_id: int = 1, temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.n_slots, self.max_len = n_slots, max_len
        self.eos = eos_id
        self.temperature = temperature
        self.device = model.embed.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = model.init_caches(n_slots, max_len, model.embed.dtype)
        self.cache_len = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.next_rid = 0
        self.pending_tok = np.zeros(n_slots, np.int32)

    # ------------------------------------------------------------ admit

    def submit(self, prompt: np.ndarray, max_new: int = 32) -> Optional[int]:
        free = np.where(~self.active)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        req = Request(self.next_rid, np.asarray(prompt, np.int32), max_new, slot=slot)
        self.next_rid += 1
        self._prefill_into(req)
        self.slot_req[slot] = req
        self.active[slot] = True
        return req.rid

    def _prefill_into(self, req: Request) -> None:
        """Prefill one prompt and copy its state rows into the pool slot
        (`copy_` casts each to the pool leaf's dtype)."""
        toks = torch.as_tensor(req.prompt, dtype=torch.long, device=self.device)[None, :]
        logits, caches_1, clen_1 = self.model.prefill(toks, self.max_len)
        for pool, one in zip(self.caches, caches_1):
            for name in pool:
                pool[name][req.slot].copy_(one[name][0])
        self.cache_len[req.slot] = int(clen_1[0])
        self.pending_tok[req.slot] = int(torch.argmax(logits[0]))
        req.out.append(int(self.pending_tok[req.slot]))

    # ------------------------------------------------------------ decode

    def step(self) -> List[Request]:
        """One batched decode across the pool; returns newly finished."""
        if not self.active.any():
            return []
        tok = torch.as_tensor(self.pending_tok, dtype=torch.long, device=self.device)
        clen = torch.as_tensor(self.cache_len, device=self.device)
        logits, self.caches = self.model.decode_step(tok, self.caches, clen)
        self.cache_len = np.where(self.active, self.cache_len + 1,
                                  self.cache_len).astype(np.int32)
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy().astype(np.int32)
        finished = []
        for slot in np.where(self.active)[0]:
            req = self.slot_req[slot]
            req.out.append(int(nxt[slot]))
            self.pending_tok[slot] = nxt[slot]
            hit_eos = nxt[slot] == self.eos
            full = int(self.cache_len[slot]) + 1 >= self.max_len
            if hit_eos or len(req.out) >= req.max_new or full:
                req.done = True
                finished.append(req)
                self.active[slot] = False
                self.slot_req[slot] = None
                self.cache_len[slot] = 0
        return finished

    def generate(self, prompts: List[np.ndarray], max_new: int = 32
                 ) -> Dict[int, List[int]]:
        """Convenience batch API with rolling admission."""
        queue = list(prompts)
        results: Dict[int, List[int]] = {}
        rid_of: Dict[int, int] = {}
        submitted = 0
        while queue or self.active.any():
            while queue:
                rid = self.submit(queue[0], max_new)
                if rid is None:
                    break
                rid_of[rid] = submitted
                submitted += 1
                queue.pop(0)
            for req in self.step():
                results[rid_of[req.rid]] = req.out
        return results
