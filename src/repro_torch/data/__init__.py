"""Training data for the port: the byte tokenizer and the synthetic
corpus of ``repro.data.pipeline``, copied."""
