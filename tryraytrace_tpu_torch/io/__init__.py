"""Image I/O: PPM files and host-side tonemapped snapshots."""
