"""Model definitions of the port: layers, decoder stack, decode state."""
