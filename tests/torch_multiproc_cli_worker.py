"""Worker of tests/test_torch_port_multiprocess.py's CLI cases: one rank of
a gloo process group on the CPU (rendezvous through a `file://` store)
running the port's CLIs in this process, as `torchrun` would run them.

  python tests/torch_multiproc_cli_worker.py CASE RANK WORLD RDZV OUTBASE

CASE 'vit': `cli.search` (2 epochs, a compress threshold that converges
in the first, so the second is postsearch with Mixup, and the fuse of
best/), then `cli.finetune` of its best/ for 2 epochs. CASE 'swin':
`cli.search_swin` with per-stage widths, --force-finish and one export
finetune epoch. Every rank is made to write its own directories (rank 0
alone writes in a real run), so the test can hold their bytes equal;
the last line is `CLI_DIGEST {json}`: each checkpoint directory's file
digests (meta.json with the rank's paths scrubbed) and the compress lines.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

COMMON = ["--data-set", "SYNTHETIC", "--synthetic-size", "48",
          "--tiny-test", "--batch-size", "8", "--num_workers", "0",
          "--compute-dtype", "float32", "--device", "cpu", "--seed", "0"]


def dir_digests(d):
    """{file: sha256} of a checkpoint directory; meta.json as its JSON
    with every string naming a rank's directory replaced."""
    out = {}
    for fn in sorted(os.listdir(d)):
        p = os.path.join(d, fn)
        if fn == "meta.json":
            with open(p) as f:
                meta = json.load(f)

            def scrub(node):
                if isinstance(node, dict):
                    return {k: scrub(v) for k, v in node.items()}
                if isinstance(node, list):
                    return [scrub(v) for v in node]
                if isinstance(node, str) and "rank" in node:
                    return "<path>"
                return node
            out[fn] = scrub(meta)
        elif os.path.isfile(p):
            with open(p, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def compress_lines(text):
    return [ln for ln in text.splitlines()
            if "prune" in ln or "Compression" in ln or "killed" in ln
            or "force-finish" in ln]


def main():
    case, rank, world, rdzv, outbase = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch.distributed as dist

    import ofb_tpu_torch.core.checkpoint as ckpt_mod
    import ofb_tpu_torch.utils.logging as olog
    from ofb_tpu_torch.cli.common import run_main
    from ofb_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed(device="cpu", init_method=f"file://{rdzv}") \
        == (rank, world)
    # every rank writes its own directories, for the byte comparison
    olog.is_main_process = lambda: True
    ckpt_mod.is_main_process = lambda: True

    out = os.path.join(outbase, f"rank{rank}")
    texts, parts = [], {}
    if case == "vit":
        from ofb_tpu_torch.cli import finetune, search
        _, text = run_main(search, COMMON + [
            "--epochs", "2", "--accum-iter", "1", "--compress-thresh", "1.0",
            "--target_flops", "0.0002", "--warmup-epochs", "1",
            "--aa", "", "--reprob", "0", "--min-crop-scale", "0.55",
            "--no-hflip", "--smoothing", "0.0", "--blr", "2e-3",
            "--blr_decoder", "2e-3", "--output_dir", out])
        texts.append(text)
        ft = out + "_ft"
        _, text = run_main(finetune, COMMON + [
            "--finetune", os.path.join(out, "best"), "--epochs", "2",
            "--mixup", "0", "--cutmix", "0", "--reprob", "0", "--aa", "",
            "--blr", "4e-3", "--layer-decay", "1.0", "--smoothing", "0.0",
            "--drop-path", "0.0", "--min-crop-scale", "0.55", "--no-hflip",
            "--warmup-epochs", "1", "--output_dir", ft])
        texts.append(text)
        parts = {"search_best": os.path.join(out, "best"),
                 "search_running": os.path.join(out, "running_ckpt"),
                 "search_fused": os.path.join(out, "model_fused"),
                 "ft_best": os.path.join(ft, "best")}
    else:
        from ofb_tpu_torch.cli import search_swin
        _, text = run_main(search_swin, COMMON + [
            "--epochs", "2", "--embed_search", "--force-finish",
            "--export-finetune-epochs", "1", "--ckpt-every", "1",
            "--output_dir", out])
        texts.append(text)
        parts = {"swin_best": os.path.join(out, "best"),
                 "swin_exported": os.path.join(out, "model_exported"),
                 "swin_finetuned": os.path.join(out, "model_finetuned")}
    digests = {k: dir_digests(v) for k, v in parts.items()}
    digests["compress_lines"] = [ln for t in texts for ln in
                                 compress_lines(t)]
    digests["world_lines"] = [ln for t in texts for ln in t.splitlines()
                              if ln.startswith("distributed:")]
    print("CLI_DIGEST " + json.dumps(digests), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
