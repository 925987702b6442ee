"""tryraytrace_tpu_torch -- the PyTorch/CUDA port of tryraytrace_tpu.

A second package beside the JAX reference: the same scenes, tables,
RNG and shading, so both render the same images.  It imports torch
and never jax.  The render path is eager PyTorch on the scene's
device; the tonemap is a hand-written CUDA kernel (ops/tonemap.py).
Entry point: ``tryraytrace_tpu_torch.engine.renderer.Renderer``.
"""

__version__ = "0.1.0"
