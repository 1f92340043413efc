"""Training: the loss, per-component AdamW, train and eval steps,
checkpoints (also written in the background), the full-parameter and LoRA
trainers, LoRA adapters and the multi-speaker orchestration."""
