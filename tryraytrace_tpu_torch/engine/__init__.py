"""The persistent path-tracing engine and the Renderer API."""
