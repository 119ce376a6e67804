"""repro_torch.runtime — the restartable training loop
(``fault_tolerance``)."""
