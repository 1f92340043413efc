"""Training: the loss, per-component AdamW, train and eval steps,
checkpoints and the full-parameter trainer."""
