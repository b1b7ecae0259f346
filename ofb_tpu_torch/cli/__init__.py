"""The port's command-line entry points: search, export, finetune, eval
(`python -m ofb_tpu_torch.cli.<name>`)."""
