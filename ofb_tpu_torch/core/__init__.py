"""Training core of the port: losses, optimizers, the search, train and eval
steps, compress, export."""
