"""Data parallelism over torch.distributed: the process group, the mesh,
the sharding rules and the collectives of the steps."""
