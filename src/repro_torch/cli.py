"""The ``repro-torch`` console script — one entry point for every CLI of the
port, the counterpart of the JAX package's ``repro`` script.

    repro-torch tune --suite gemm --trials 32       # repro_torch.search.tune
    repro-torch model train --suite gemm,conv ...   # repro_torch.search.model
    repro-torch compile --suite smoke --validate    # repro_torch.compile
    repro-torch graph --validate                    # repro_torch.graph (K1)
    repro-torch fabric --shape 5124x700x2048 ...    # repro_torch.fabric
    repro-torch dryrun --arch olmo-1b --shape train_4k --mesh single
    repro-torch train / repro-torch serve           # repro_torch.launch.*
    repro-torch servesim --compare --requests 64    # repro_torch.serve
    repro-torch verify --mutate                     # repro_torch.verify

Installed via ``[project.scripts]``; ``python -m repro_torch.cli`` runs the
same ``main``.  Each subcommand defers to the module's own
``main``/argparse, so ``repro-torch tune --help`` shows exactly what
``python -m repro_torch.search.tune --help`` does.  The JAX script's
``bench`` (the ``benchmarks`` harness, which runs the JAX package) has no
counterpart: the benchmarks are not ported.
"""
from __future__ import annotations

import sys

#: subcommand -> (module, description).  Modules import lazily, so the
#: dispatcher stays instant for --help.
COMMANDS = {
    "tune": ("repro_torch.search.tune", "joint mapping/schedule autotuner"),
    "model": ("repro_torch.search.model",
              "learned cost model train/eval/export"),
    "compile": ("repro_torch.compile.__main__", "compilation driver CLI"),
    "verify": ("repro_torch.verify.cli", "static analyzer sweep + mutation "
                                         "harness"),
    "graph": ("repro_torch.graph.__main__", "whole-model graph trace/fuse/"
                                            "compile"),
    "fabric": ("repro_torch.fabric.simulate", "multi-chip fabric simulator"),
    "dryrun": ("repro_torch.launch.dryrun", "dry-run roofline matrix"),
    "train": ("repro_torch.launch.train", "training launch"),
    "serve": ("repro_torch.launch.serve", "serving launch"),
    "servesim": ("repro_torch.serve.__main__", "online continuous-batching "
                                               "serving simulator"),
}


def _usage(out=None) -> None:
    out = sys.stderr if out is None else out
    print("usage: repro-torch <command> [args...]\n\ncommands:", file=out)
    for name, (_, desc) in COMMANDS.items():
        print(f"  {name:<9} {desc}", file=out)
    print("\n'repro-torch <command> --help' shows the command's own options."
          "\n(The benchmark harness, 'bench', is not ported.)", file=out)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        _usage(sys.stdout if argv else sys.stderr)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"repro-torch: unknown command {cmd!r}", file=sys.stderr)
        _usage()
        return 2
    module_name = COMMANDS[cmd][0]
    import importlib
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        print(f"repro-torch {cmd}: cannot import {module_name} ({e})",
              file=sys.stderr)
        return 2
    run = getattr(module, "main", None)
    if run is None:                     # pragma: no cover - all have main()
        print(f"repro-torch {cmd}: {module_name} has no main()",
              file=sys.stderr)
        return 2
    # Every module's main() parses sys.argv through argparse's default, so
    # the argv slice is spliced into sys.argv for the call (and put back
    # after it: the dispatcher also runs in process).
    saved, sys.argv = sys.argv, [f"repro-torch {cmd}"] + rest
    try:
        ret = run()
    except SystemExit as e:
        if isinstance(e.code, str):      # sys.exit("message") convention
            print(e.code, file=sys.stderr)
            return 1
        return int(e.code or 0)
    finally:
        sys.argv = saved
    return int(ret or 0)


if __name__ == "__main__":
    raise SystemExit(main())
