"""repro_torch.checkpoint — atomic, async-capable checkpointing in the JAX
package's on-disk format (``ckpt``)."""
