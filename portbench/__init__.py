"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ISA Mapper.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card: ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  Everything a cell is made of is
found by name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (which
names its program entry, ``entries/<entry>.py``) and ``metrics/<metric>.py``.
"""
