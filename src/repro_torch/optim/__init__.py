"""repro_torch.optim — AdamW with global-norm clipping and a cosine
schedule, the JAX package's formula (``adamw``)."""
