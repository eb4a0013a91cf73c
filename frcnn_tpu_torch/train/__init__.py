"""Training: the joint objective, optimizers and the trainer."""
