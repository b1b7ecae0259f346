"""Walkthroughs of the library API, the ports of the repo's `examples/`:
`minimal_search` (search -> compress -> export -> finetune on a tiny
supernet) and `compression_story` (a tiny supernet searched, pruned
organically, exported and finetuned on an 8-class synthetic task). Run as
`python -m ofb_tpu_torch.examples.<name>`; on the card unless `--device
cpu` asks for the CPU.
"""
