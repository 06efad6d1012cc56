"""Training: optimizer, trainable stages, train/val step, checkpoints."""
