"""Batched serving driver: prefill the prompt, then decode token by token
against a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --batch 4 --prompt-len 16 --gen 16

Runs on the card unless ``--device cpu`` is given (``--smoke`` takes the
reduced config, small enough for the CPU).  Weights, prompt tokens and
frontend embeddings are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..kernels.cuda import resolve_device
from ..models import build_model


def _mark(device: torch.device):
    """A point in time: a recorded CUDA event on the card, else the host
    clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


@torch.no_grad()
def generate(model, batch, max_new: int, greedy: bool = True,
             generator: torch.Generator | None = None,
             record: dict | None = None) -> torch.Tensor:
    """Prefill the prompt, then decode ``max_new`` tokens; (B, max_new)
    int32.  Greedy picks the first maximum; otherwise each token is drawn
    from softmax(logits) with ``generator``.  The weights are cast to the
    activation dtype once for the call (``cast_weights``).

    ``record``, when a dict, receives ``logits`` (B, max_new + 1, V): row 0
    from the prefill, row i + 1 from the decode step of token i, and the
    times in ms (CUDA events on the card): ``cast_ms``, ``prefill_ms`` and
    ``decode_ms`` (one per step)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    B, T = tokens.shape
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    max_len = prefix + T + max_new
    dev = tokens.device
    marks = [_mark(dev)]
    with model.cast_weights():
        marks.append(_mark(dev))
        cache, logits = model.prefill(batch, max_len=max_len)
        marks.append(_mark(dev))
        seen = [logits[:, -1]]
        out = []
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        for i in range(max_new):
            out.append(cur)
            logits, cache = model.decode_step(cache, cur, prefix + T + i)
            marks.append(_mark(dev))
            seen.append(logits)
            if greedy:
                cur = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                cur = torch.multinomial(probs, 1, generator=generator
                                        )[:, 0].to(torch.int32)
    toks = torch.stack(out, dim=1)
    if record is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record["logits"] = torch.stack(seen, dim=1)
        record["cast_ms"] = _ms(marks[0], marks[1])
        record["prefill_ms"] = _ms(marks[1], marks[2])
        record["decode_ms"] = [_ms(a, b) for a, b in zip(marks[2:],
                                                         marks[3:])]
    return toks


def make_batch(cfg, batch: int, prompt_len: int, device,
               generator: torch.Generator) -> dict:
    """Random prompt tokens and, for the frontend families, their stub
    inputs: zero patch embeddings (VLM), normal frame embeddings (audio)."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator, device=device,
                                   dtype=torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros(
            (batch, cfg.frontend_tokens, cfg.d_model),
            dtype=cfg.activation_dtype, device=device)
    if cfg.family == "audio":
        out["audio_embeds"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.d_model), generator=generator,
            device=device).to(cfg.activation_dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", action="store_true",
                    help="sample from the logits instead of greedy argmax")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises when "
                         "there is none)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the prompt and the sampling")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the result record as JSON")
    ap.add_argument("--tuned", action="store_true",
                    help="activate the repro_torch.search tuning cache and "
                         "the repro_torch.compile artifact cache for this "
                         "process: cache-aware kernels pick up autotuned "
                         "configs and precompiled artifacts")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="tuning cache path (with --tuned)")
    ap.add_argument("--compile-cache", default=None, metavar="PATH",
                    help="artifact cache path (with --tuned)")
    ap.add_argument("--tuning-model", default=None, metavar="PATH",
                    help="learned cost model store (with --tuned): untuned "
                         "GEMM shapes get a model-predicted block")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.tuned:
        from .caches import activate_caches
        activate_caches(args.tuning_cache, args.compile_cache, tag="serve",
                        model_path=args.tuning_model)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = build_model(cfg, dev).init(gen)
    batch = make_batch(cfg, args.batch, args.prompt_len, dev, gen)

    t0 = time.perf_counter()
    toks = generate(model, batch, args.gen, greedy=not args.sample,
                    generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    record = {
        "arch": cfg.name, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "greedy": not args.sample,
        "tokens": int(total), "wall_s": round(dt, 3),
        "tok_per_s": round(total / dt, 2),
        "sample": toks[0, :8].cpu().tolist(),
    }
    print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": 1, "rows": [record]}, f, indent=2)
    return toks


if __name__ == "__main__":
    main()
