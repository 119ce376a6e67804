"""``repro-torch graph`` — trace, fuse, compile and validate a whole model
block.

    repro-torch graph                             # olmo-1b block, fused
    repro-torch graph --arch qwen2-7b --seq 16    # another config / seq len
    repro-torch graph --no-fuse                   # keep epilogues standalone
    repro-torch graph --gru                       # the unrolled-GRU tracer
    repro-torch graph --cache arts.json           # persistent artifact cache
    repro-torch graph --cache arts.json --expect-cached  # 2nd run: all hits
    repro-torch graph --validate                  # oracle + executed run on
                                                  #   the card vs the float64
                                                  #   reference, bit-exact
    repro-torch graph --validate --device cpu     # the same on the CPU
    repro-torch graph --whisper-layers 2 --validate  # whisper's decoder
                                                  #   stack, held within
                                                  #   WHISPER_REL

The block is compiled against the port's target, ``gpu_sm(8)``.  Per-node
table shows which kernel each node mapped to and whether the compile was
deduped (same program fingerprint) or served from the cache.
``--validate`` runs ``CompiledGraph.execute`` on ``--device`` (default: the
card, where each ``pallas_gpu_gemm`` node is one K1 launch; without a card
it raises unless ``--device cpu`` is given) and holds every output against
``interpret_graph`` and, for the block tracer, the torch float64 reference
(``models.traceable.block_reference``) on the same device.
``--whisper-layers N`` traces N layers of whisper's decoder and its head
(``trace_whisper_decoder``, ``--seq`` tokens over ``WHISPER_FRAMES``
encoder frames) at the ``--arch`` trace config's widths; its values are
not integers, so ``--validate`` holds it within a relative RMS error of
``WHISPER_REL`` of the interpreter and of the float64 reference
(``models.whisper_block_reference``) rather than bit for bit.  Exit status:
0 iff compilation, ``--validate`` and ``--expect-cached`` all hold.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

#: ``--validate``'s relative RMS bound for the whisper stack: f32 node
#: boundaries and f32 GEMM sums against float64 (about 1e-7 at the trace
#: config's size)
WHISPER_REL = 1e-5
#: the encoder frames the whisper stack attends to
WHISPER_FRAMES = 12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch graph",
        description="Whole-model graph compilation: trace a model config "
                    "into a kernel graph, fuse epilogues, compile every "
                    "node (deduped), place buffers and report the "
                    "simulated end-to-end makespan.")
    ap.add_argument("--arch", default="olmo-1b",
                    help="model config to trace (default olmo-1b)")
    ap.add_argument("--seq", type=int, default=8,
                    help="trace sequence length (default 8)")
    ap.add_argument("--gru", action="store_true",
                    help="trace the unrolled GRU chain instead of the "
                         "transformer block")
    ap.add_argument("--whisper-layers", type=int, default=0, metavar="N",
                    help="trace N layers of whisper's decoder stack and its "
                         "head instead of the transformer block")
    ap.add_argument("--no-fuse", action="store_true",
                    help="skip epilogue fusion")
    ap.add_argument("--budget", type=int, default=None,
                    help="residency budget in bytes (default: half the "
                         "target's fastest memory)")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="artifact cache file (enables cross-run reuse)")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless every unique compile is a cache hit")
    ap.add_argument("--validate", action="store_true",
                    help="check interpreted + executed outputs bit-exact "
                         "(vs the float64 reference for the block tracer)")
    ap.add_argument("--device", default=None,
                    help="torch device --validate executes on (default: the "
                         "card; raises when there is none)")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    from ..compile.cache import ArtifactCache
    from ..configs.registry import get_trace_config
    from ..kernels.cuda import resolve_device
    from ..models.traceable import block_reference
    from .compile import compile_graph
    from .fuse import fuse_epilogues
    from .ir import interpret_graph
    from .trace import (assert_exactness_bound, block_inputs, trace_block,
                        trace_gru_chain, trace_whisper_decoder)

    failures = 0
    if args.gru:
        cfg = None
        g = trace_gru_chain()
    elif args.whisper_layers:
        cfg = get_trace_config(args.arch)
        g = trace_whisper_decoder(cfg, args.seq, WHISPER_FRAMES,
                                  args.whisper_layers)
    else:
        cfg = get_trace_config(args.arch)
        g = trace_block(cfg, seq_len=args.seq)
    print(f"traced   {g.summary()}")

    decisions = []
    if not args.no_fuse:
        g, decisions = fuse_epilogues(g)
        for d in decisions:
            print(f"  fused  {d.consumer} -> {d.producer} "
                  f"(-{d.saved_bytes}B via {d.tensor})")
        print(f"fused    {g.summary()}")

    cache = ArtifactCache(args.cache) if args.cache else None
    cg = compile_graph(g, cache=cache, use_cache=cache is not None,
                       vmem_budget=args.budget, decisions=decisions)

    seen: set[str] = set()
    for node in g.nodes:
        fp = cg.node_kernels[node.name]
        art = cg.kernels[fp]
        if fp in seen:
            src = "dedup"
        else:
            src = "cache" if art.from_cache else "fresh"
            seen.add(fp)
        print(f"  {node.name:<14} {node.program.name:<40} "
              f"cost={art.cost:.3e}s [{src}]")
    s = cg.stats
    print(f"compiled {cg.summary()}")
    print(f"         dedupe={s['dedupe']}x "
          f"({s['nodes']} nodes / {s['unique_programs']} compiles), "
          f"fresh={s['fresh_compiles']} cached={s['cache_hits']}")
    if cg.placement and cg.placement.spilled():
        print(f"         spilled to hbm: {', '.join(cg.placement.spilled())}")

    if args.expect_cached and s["fresh_compiles"]:
        print(f"[FAIL] --expect-cached: {s['fresh_compiles']} fresh "
              f"compile(s), expected all {s['unique_programs']} from cache")
        failures += 1

    validated = None
    if args.validate and args.whisper_layers:
        validated = _validate_whisper(cg, g, cfg, args)
        failures += not validated
    elif args.validate:
        dev = resolve_device(args.device)
        inputs = block_inputs(g)
        interp = interpret_graph(g, inputs)
        worst = assert_exactness_bound(interpret_graph(g, inputs,
                                                       return_all=True))
        executed = {t: v.cpu().numpy()
                    for t, v in cg.execute(inputs, device=dev).items()}
        checks = [("executed-vs-interpreted",
                   all(np.array_equal(executed[t], interp[t])
                       for t in interp))]
        if cfg is not None:
            ref = block_reference(inputs, cfg, args.seq,
                                  device=dev).cpu().numpy()
            checks += [("interpreted-vs-reference",
                        all(np.array_equal(v, ref) for v in interp.values())),
                       ("executed-vs-reference",
                        all(np.array_equal(v, ref)
                            for v in executed.values()))]
        validated = all(ok for _, ok in checks)
        for name, ok in checks:
            print(f"  [{'ok' if ok else 'FAIL'}] {name}: bit-exact={ok}")
            failures += not ok
        print(f"validate max |tensor| = {worst:.1f} "
              f"(f32-exact bound 2^24)")

    if args.json:
        payload = {"schema": 1, "failures": failures,
                   "graph": g.summary(), "graph_fp": g.fingerprint(),
                   "stats": dict(s), "makespan": cg.makespan,
                   "hbm_bytes": cg.hbm_bytes, "edge_bytes": cg.edge_bytes,
                   "decisions": [d.to_dict() for d in decisions],
                   "placement": cg.placement.to_dict(),
                   "validated": validated}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# report: {args.json}")
    print(f"# makespan={cg.makespan:.3e}s hbm={cg.hbm_bytes}B "
          f"edge={cg.edge_bytes}B, {failures} failure(s)")
    return 1 if failures else 0


def _validate_whisper(cg, g, cfg, args) -> bool:
    """The whisper stack executed on ``--device`` and interpreted, each
    within ``WHISPER_REL`` of the other and of the float64 reference, on
    weights and inputs drawn from seed 0."""
    import torch

    from ..kernels.cuda import resolve_device
    from ..models import whisper_block_reference as ref
    from .ir import interpret_graph
    from .trace import whisper_inputs

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = ref.init_params(cfg.d_model, cfg.d_ff, cfg.vocab_size,
                             args.whisper_layers, gen, dev)
    x = torch.randn(args.seq, cfg.d_model, generator=gen, device=dev)
    xa = torch.randn(WHISPER_FRAMES, cfg.d_model, generator=gen, device=dev)
    inputs = whisper_inputs(g, params, x, xa)
    want = dict(zip(g.outputs, ref.decoder(params, x, xa, cfg.n_heads,
                                           args.whisper_layers)))
    interp = interpret_graph(g, {t: v.cpu().numpy()
                                 for t, v in inputs.items()})
    executed = cg.execute(inputs, device=dev)

    def rel(got, ref_t) -> float:
        got = torch.as_tensor(got).to(ref_t.device, torch.float64)
        return float((got - ref_t).norm() / ref_t.norm())
    checks = [("executed-vs-interpreted",
               max(rel(executed[t], torch.as_tensor(interp[t]).to(dev)
                       .double()) for t in g.outputs)),
              ("interpreted-vs-reference",
               max(rel(interp[t], want[t]) for t in g.outputs)),
              ("executed-vs-reference",
               max(rel(executed[t], want[t]) for t in g.outputs))]
    for name, err in checks:
        ok = err <= WHISPER_REL
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: rel_rms={err:.3e} "
              f"(limit {WHISPER_REL:g})")
    return all(err <= WHISPER_REL for _, err in checks)


if __name__ == "__main__":
    raise SystemExit(main())
