"""The parallel layer: (dp, sp) meshes over torch.distributed."""
