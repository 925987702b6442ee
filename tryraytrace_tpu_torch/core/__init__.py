"""Counter-based RNG and float3 helpers on torch tensors."""
