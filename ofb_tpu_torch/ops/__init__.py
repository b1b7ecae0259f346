"""Ops of the port: gate math, attention kernels, PMIM, FLOPs model."""
