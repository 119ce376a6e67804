"""repro_torch — the ISA Mapper compiler and its kernels on PyTorch and CUDA.

The compiler tiers (``core``, ``compile``) are pure Python and numpy: they
map an ISAMIR program onto an instruction set, schedule it against a target
``SystemGraph`` and lower it to a tile plan.  ``kernels`` holds the
hand-written CUDA kernels (sources under ``csrc/``) that run that plan on an
NVIDIA Hopper card, each beside its plain PyTorch version.
"""
