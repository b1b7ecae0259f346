"""Run utilities of the port: metric logging, run logs, auto-resume."""
