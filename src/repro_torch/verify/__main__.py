"""``python -m repro_torch.verify`` — the analyzer sweep of ``cli.py``."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
