"""The kernels: hand-written CUDA for Hopper (sources under ``csrc/``), each
beside its plain PyTorch version (``ref``), and the bridge from the
compiler's plan to their launch (``ops``)."""
