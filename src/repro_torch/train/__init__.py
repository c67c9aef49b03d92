"""Training: the optimizers the hybrid pipeline's retraining uses."""
