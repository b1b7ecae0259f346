"""The experiment layer: the scripts and tools that turn the CLIs into an
accuracy-vs-FLOPs ladder (OFB-DeiT-A..E, OFB-Swin-A..C) and read its
roots. Each file keeps the name of its counterpart in the repo's
`scripts/`.

- ladders and runs: `ladder_imnet.sh` (two-stage search +
  export/finetune per FLOPs target, resumable, then the dense comparator
  and the table),
  `ladder_swin.sh`, `run_exp.sh` (one two-stage run), `ladder.py` and
  `digits_story.py` (the same at digits scale, in process);
- tools over a ladder root: `ladder_imnet_summary`, `ladder_hard_eval`,
  `run_status`, `frontier`;
- search dynamics: `prune_timeline`, `alpha_dynamics`, `alpha_tail`;
- data: `make_imagefolder`.

The Python tools run as `python -m ofb_tpu_torch.scripts.<name>`; the
shell scripts as `bash ofb_tpu_torch/scripts/<name>.sh ROOT`, and run the
CLIs with `python -m` from the root of the checkout.
"""
