"""Serving launcher: continuous-batching decode engine on a smoke config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --requests 16 --max-new 24 [--device cpu]

``--arch`` names a dense, MoE, ssm or hybrid architecture
(``h2o-danube-1.8b``, ``codeqwen1.5-7b``, ``gemma2-9b``,
``granite-moe-1b-a400m``, ``phi3.5-moe-42b-a6.6b``, ``mamba2-780m``,
``zamba2-2.7b``, ``pixtral-12b`` (its prompts without an image prefix),
...), each with the KV cache its config names (int8 where
``kv_cache_dtype="int8"``); the engine refuses the encoder-decoder
family, whose model runs ``EncDecLM.encode``, ``init_dec_cache`` and
``decode_step`` instead.

Without ``--device`` the engine runs on the card (and raises without one);
``--device cpu`` runs the kernels' plain versions on the CPU.
"""
import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.serving import ContinuousBatcher, DecodeEngine, Request

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init(0, torch.float32, device)
    engine = DecodeEngine(cfg, params, slots=args.slots,
                          max_len=args.prompt_len + args.max_new + 8,
                          device=device)
    batcher = ContinuousBatcher(engine)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        batcher.submit(Request(i, rng.integers(0, cfg.vocab, args.prompt_len),
                               args.max_new))
    done = batcher.drain()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {engine.steps} decode steps) on {device}")
    return done


if __name__ == "__main__":
    main()
