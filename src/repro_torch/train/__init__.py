"""Training: the optimizers (the hybrid pipeline's retraining and the LM's
AdamW) and the LM train step."""
