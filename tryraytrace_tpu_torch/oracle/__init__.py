"""The NumPy oracle renderer (oracle/cpu_renderer.py)."""

from tryraytrace_tpu_torch.oracle.cpu_renderer import oracle_render  # noqa: F401
