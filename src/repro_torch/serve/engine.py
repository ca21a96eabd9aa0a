"""Batched serving engine: prefill + aligned-batch decode with a KV cache.

The port of :mod:`repro.serve.engine`.  One prefill builds the cache from
the prompts; each decode step feeds one new token per sequence against the
standing cache (aligned batching: every slot shares the position counter).
Sampling is greedy (``temperature = 0``) or from the softmax of the
logits over the temperature, drawn from a ``torch.Generator`` on the
params' device seeded with ``ServeConfig.seed``.  Step latencies are
honest: the clock is read after ``torch.cuda.synchronize()`` on the card,
where the reference blocks until its result is ready.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serve.metrics import throughput_summary

__all__ = ["ServeConfig", "ServeEngine"]


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8
    max_len: int = 512
    temperature: float = 0.0       # 0 = greedy
    eos_id: int = -1               # -1 = never stop early
    seed: int = 0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig):
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = api.device_of(params)
        self.generator = torch.Generator(device=self.device).manual_seed(
            sc.seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1].float()
        if self.sc.temperature <= 0:
            return torch.argmax(last, dim=-1).to(torch.int32)
        probs = torch.softmax(last / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .to(torch.int32)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 enc_embed: Optional[np.ndarray] = None):
        """prompts: (B, S) int (aligned).  Returns (tokens (B, n), stats)."""
        if enc_embed is not None or self.cfg.is_enc_dec:
            raise NotImplementedError(
                "encoder-decoder serving is not ported yet "
                "(ROADMAP Queue 1 item 18)")
        b, s = prompts.shape
        if b != self.sc.batch_size:
            raise ValueError(f"batch of {b} prompts, engine batch size "
                             f"{self.sc.batch_size}")
        if s + max_new_tokens - 1 > self.sc.max_len:
            raise ValueError(f"{s} prompt tokens + {max_new_tokens} new "
                             f"exceed max_len {self.sc.max_len}")
        batch = {"tokens": torch.as_tensor(np.asarray(prompts)).to(
            self.device)}

        self._sync()
        t0 = time.perf_counter()
        logits, cache = api.prefill(self.cfg, self.params, batch,
                                    max_len=self.sc.max_len)
        tok = self._sample(logits)
        self._sync()
        t_prefill = time.perf_counter() - t0

        out = [tok.cpu().numpy()]
        done = np.zeros((b,), bool)
        t1 = time.perf_counter()
        steps = 0
        step_s = []
        for i in range(max_new_tokens - 1):
            ts = time.perf_counter()
            logits, cache = api.decode_step(self.cfg, self.params, cache,
                                            tok[:, None], s + i)
            tok = self._sample(logits)
            steps += 1
            self._sync()
            step_s.append(time.perf_counter() - ts)
            cur = tok.cpu().numpy()
            out.append(cur)
            if self.sc.eos_id >= 0:
                done |= cur == self.sc.eos_id
                if done.all():
                    break
        self._sync()
        t_decode = time.perf_counter() - t1
        tokens = np.stack(out, axis=1)
        # the shared summary schema (SUMMARY_KEYS) + the engine's own keys
        stats = throughput_summary(
            t_prefill + t_decode, b * (1 + steps), latency=step_s)
        stats.update(
            prefill_s=t_prefill,
            decode_s=t_decode,
            decode_tok_per_s=b * max(steps, 1) / max(t_decode, 1e-9),
        )
        return tokens, stats
