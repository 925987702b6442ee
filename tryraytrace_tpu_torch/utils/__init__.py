"""Host utilities of the port: structured logging and phase timing."""
