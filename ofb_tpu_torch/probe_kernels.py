"""Probe: where the resident and the streaming attention kernels spend
their time.

There is no hardware profiler to ask on every machine, so this script asks
the kernels themselves: it builds edited copies of `csrc/` (each variant a
few exact source replacements that take work out, route it elsewhere or
change a block's shape), and times the forward and the backward of every
variant at its body's batch-256 shape (the resident body at the search
step's N = 197, the streaming one at DeiT-S-384's N = 577), each variant
in a process of its own, two rounds. The differences between variants say
how long the copies, each pass and the alternatives take. A replacement
whose text is no longer in the source fails the run, so a stale variant
cannot pass unnoticed.

Usage: python -m ofb_tpu_torch.probe_kernels [resident] [streaming]
(both bodies' variants without arguments). Needs a CUDA device and nvcc.
Copies and libraries go to build/ofb_tpu_torch_probe/ (git-ignored).
Prints one line a variant and round: its name, forward ms, backward ms,
the shape and the card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

# B, N, H, d at batch 256: DeiT-S at 224 and at 384 pixels
SHAPES = {"resident": (256, 197, 6, 64), "streaming": (256, 577, 6, 64)}
FWD = "attention_fwd_resident.cu"
BWD = "attention_bwd_resident.cu"
SFWD = "attention_fwd_streaming.cu"
SBWD = "attention_bwd_streaming.cu"
ROOT = Path(__file__).resolve().parents[1] / "build" / "ofb_tpu_torch_probe"

_DQ_LOOP = ("      for (; key0 + ROWS <= NP; key0 += ROWS)\n"
            "        dq_step<DP, 64>(acc, Qt, dOt, Ks, Vs, NR,")
_DQ_TAIL = ("      if constexpr (TAIL > 0)\n"
            "        dq_step<DP, TAIL>(acc, Qt, dOt, Ks, Vs, NR,")
_KV_LOOP = ("      for (; q0 + ROWS <= NP; q0 += ROWS)\n"
            "        dkdv_step<DP, 64>(acc_k, acc_v, Kt, Vt, Qs, dOs, NR,")
_KV_TAIL = ("      if constexpr (TAIL > 0)\n"
            "        dkdv_step<DP, TAIL>(acc_k, acc_v, Kt, Vt, Qs, dOs, NR,")
# the fused backward without its dq pass, without its dk/dv pass
_NO_DQ = [(BWD, _DQ_LOOP, _DQ_LOOP.replace("<= NP", "<= 0")),
          (BWD, _DQ_TAIL, _DQ_TAIL.replace("TAIL > 0", "TAIL > 64"))]
_NO_KV = [(BWD, _KV_LOOP, _KV_LOOP.replace("<= NP", "<= 0")),
          (BWD, _KV_TAIL, _KV_TAIL.replace("TAIL > 0", "TAIL > 64"))]
_FUSED_CALL = (
    "      return launch_bwd_fused<tail>(q, k, v, o, dout, lse, dq, dk, dv, "
    "B, N, \\\n                                    H, d, strides, s);"
    "                       \\\n")
_FWD_BOUNDS = "__global__ void __launch_bounds__(WG)\nattention_fwd_resident"

# name -> [(source file, text, replacement)]; outputs of a variant that
# skips work are wrong, only its time is read
RESIDENT_VARIANTS = {
    "as_committed": [],
    # the backward's copies in, delta, and stores out, no products
    "bwd_copies_only": _NO_DQ + _NO_KV,
    "bwd_dq_pass_only": _NO_KV,
    "bwd_dkdv_pass_only": _NO_DQ,
    # d <= 64 through the dq kernel and the dk/dv kernel instead of the
    # fused one
    "bwd_two_kernels": [(BWD, _FUSED_CALL,
                         "      return launch_bwd<64, tail>(q, k, v, o, dout, "
                         "lse, delta, dq, dk, dv, B, N, H, d, strides, s); \\\n")],
    # the forward's first query tile only: k, v and one q tile copied, one
    # of four tiles computed and stored
    "fwd_first_tile_only": [(FWD, "  for (int t = 0; t < ntiles; ++t) {",
                             "  for (int t = 0; t < 1; ++t) {")],
    # the forward held to 168 registers so that three blocks fit an SM
    "fwd_three_blocks": [(FWD, _FWD_BOUNDS, _FWD_BOUNDS.replace(
        "(WG)", "(WG, (DP == 64 && CH * NCH <= 208) ? 3 : 1)"))],
}
_BWD_WGS = "constexpr int DQ_WGS = 1, KV_WGS = 2;"
STREAMING_VARIANTS = {
    "streaming_as_committed": [],
    # one warpgroup (64 query rows) a forward block: K and V pass through
    # L2 once for every 64 query rows instead of every 128
    "stream_fwd_one_warpgroup": [(SFWD, "constexpr int WGS = 2;",
                                  "constexpr int WGS = 1;")],
    # K/V tiles copied one and three ahead (rings of three and five)
    "stream_fwd_copies_1_ahead": [(SFWD, "constexpr int AHEAD = 2;",
                                   "constexpr int AHEAD = 1;")],
    "stream_fwd_copies_3_ahead": [(SFWD, "constexpr int AHEAD = 2;",
                                   "constexpr int AHEAD = 3;")],
    # the dq kernel at two warpgroups a block (one block an SM by
    # registers), the dk/dv kernel at one
    "stream_dq_two_warpgroups": [(SBWD, _BWD_WGS, _BWD_WGS.replace(
        "DQ_WGS = 1", "DQ_WGS = 2"))],
    "stream_dkdv_one_warpgroup": [(SBWD, _BWD_WGS, _BWD_WGS.replace(
        "KV_WGS = 2", "KV_WGS = 1"))],
    "stream_bwd_copies_2_ahead": [(SBWD, "DQ_AHEAD = 1, KV_AHEAD = 1",
                                   "DQ_AHEAD = 2, KV_AHEAD = 2")],
}
BODY_VARIANTS = {"resident": RESIDENT_VARIANTS,
                 "streaming": STREAMING_VARIANTS}


def _use(name: str):
    """Point cuda_build at a variant's sources and libraries."""
    from .ops import cuda_build
    cuda_build.CSRC = ROOT / name / "csrc"
    cuda_build.BUILD_DIR = ROOT / name / "lib"
    return cuda_build


def _write_variant(name: str, edits) -> None:
    dst = ROOT / name / "csrc"
    dst.mkdir(parents=True, exist_ok=True)
    for src in (Path(__file__).resolve().parent / "csrc").iterdir():
        text = src.read_text()
        for fname, old, new in edits:
            if src.name == fname:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {fname} does not "
                                       f"hold exactly once:\n{old}")
                text = text.replace(old, new)
        (dst / src.name).write_text(text)


def _body(name: str) -> str:
    return next(b for b, vs in BODY_VARIANTS.items() if name in vs)


def _time_variant(name: str) -> None:
    import torch

    from .bench import card
    from .ops import attention as A
    _use(name)
    body = _body(name)

    def ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    B, N, H, d = SHAPES[body]
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn((B, N, 3, H, d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q = (buf[:, :, 0].float() * d ** -0.5).to(torch.bfloat16)
    k, v = buf[:, :, 1], buf[:, :, 2]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = A.attention_fwd(q, k, v, body=body)
    t_fwd = ms(lambda: A.attention_fwd(q, k, v, body=body))
    t_bwd = ms(lambda: A.attention_bwd(q, k, v, o, lse, do, body=body))
    print(f"{name:26s} fwd {t_fwd:.4f} ms  bwd {t_bwd:.4f} ms  "
          f"B={B} N={N} H={H} d={d} bf16  [{card()}]", flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--variant"]:        # a child: time one built variant
        _time_variant(args[1])
        return 0
    variants = {n: e for body in (args or list(BODY_VARIANTS))
                for n, e in BODY_VARIANTS[body].items()}
    procs = []
    for name, edits in variants.items():  # every nvcc at once
        _write_variant(name, edits)
        cb = _use(name)
        cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        body = _body(name)
        for lib in (f"attention_fwd_{body}", f"attention_bwd_{body}"):
            cmd = [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o",
                   str(cb.library_path(lib)), str(cb.CSRC / cb.SOURCES[lib])]
            procs.append((name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: {lib} did not build:\n{log}")
    for _ in range(2):
        for name in variants:
            subprocess.run([sys.executable, "-m", "ofb_tpu_torch.probe_kernels",
                            "--variant", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
