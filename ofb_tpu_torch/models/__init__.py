"""Models of the port: search space, ViT, gated MIM supernet, pos-embed
utilities, registry."""
