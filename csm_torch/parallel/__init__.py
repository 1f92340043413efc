"""Training over a mesh of ranks on ``torch.distributed``: data, FSDP,
tensor, pipeline and ring-sequence parallelism (the JAX package's
``parallel/`` for training; sharded inference waits, ROADMAP.md A.11b)."""
