"""repro_torch.data — the deterministic, step-keyed data pipeline
(``pipeline``)."""
