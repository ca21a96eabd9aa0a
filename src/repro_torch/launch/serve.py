"""Serving driver:
``python -m repro_torch.launch.serve --arch phi3-medium-14b [--smoke]
[--device cpu]``.

Makes seeded random weights, runs batched prefill + decode through the
engine and reports prefill latency and decode throughput.  It runs on the
GPU unless ``--device`` names another device, and raises without one.
``--smoke`` takes the reduced config (CPU-sized).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import api
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    params = api.init_params(cfg, 0, args.device)
    engine = ServeEngine(cfg, params, ServeConfig(
        batch_size=args.batch, max_len=args.max_len,
        temperature=args.temperature))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    tokens, stats = engine.generate(prompts, args.new_tokens)
    print(f"{cfg.name} on {engine.device}: generated {tokens.shape}; "
          f"prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s")
    return tokens, stats


if __name__ == "__main__":
    main()
