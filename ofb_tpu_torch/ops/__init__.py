"""Ops of the port: gate math, attention kernels, PMIM, Mixup / CutMix,
FLOPs model."""
