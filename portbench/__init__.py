"""The benchmark of the PyTorch and CUDA port (``repro_torch``): agentic
serving cells run through the port's serving front end, their metrics, and
the plain references that decide whether the served tokens are correct.
See README.md."""
