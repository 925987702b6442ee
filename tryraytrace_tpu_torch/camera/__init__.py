"""Camera controller and per-frame camera parameters."""
