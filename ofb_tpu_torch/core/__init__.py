"""Training core of the port: losses, optimizer, search step."""
