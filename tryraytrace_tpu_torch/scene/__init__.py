"""Host-side scene model, loaders and procedural assets (NumPy)."""
