"""Data path of the port: datasets, samplers, the host loader, the device
feed and the device cache."""
