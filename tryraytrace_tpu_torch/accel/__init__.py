"""Accelerator structures: the BVH build and the quad/trimat table packers."""
