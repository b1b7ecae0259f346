"""Models of the port: search space, ViT, gated MIM supernet, registry."""
