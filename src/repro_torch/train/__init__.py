"""Training for the port: AdamW, the next-token loss and the train step,
and flat-npz checkpoints readable by the JAX package."""
