"""PyTorch / CUDA port of the ``repro`` package (Agent.xpu serving stack).

Imports ``torch`` and never ``jax``, and nothing of ``repro``: the JAX
package stays beside it as the reference the port is tested against.
"""
