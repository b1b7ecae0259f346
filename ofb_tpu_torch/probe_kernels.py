"""Probe: where the resident, the streaming, the unaligned and the general
(fp32) attention kernels spend their time.

There is no hardware profiler to ask on every machine, so this script asks
the kernels themselves: it builds edited copies of `csrc/` (each variant a
few exact source replacements that take work out, route it elsewhere or
change a block's shape), and times the forward and the backward of every
variant at its body's batch-256 shape (the resident body at the search
step's N = 197, the streaming one at DeiT-S-384's N = 577, both bf16; the
unaligned one at N = 197 with rows one element into wider rows, so that
they start on 2 bytes only, and with head dim 20, rows on 8 bytes; the
general body in fp32, the type it serves, at N = 197), each variant in a
process of its own, two rounds. The differences between variants say
how long the copies, each pass and the alternatives take. A replacement
whose text is no longer in the source fails the run, so a stale variant
cannot pass unnoticed. The streaming variants turn the knobs of its TMA /
mbarrier / ping-pong design one at a time (ring depth, the setmaxnreg
split, ping-pong off, the pipelining inside a warpgroup off, and at
ViT-H/14's shape the forward's narrow last tile and the d = 80 tail off),
and take out the forward's exponentials, products or loads. The unaligned
variants copy rows on 8 bytes by 4-byte cp.async, or stage them as rows on
2 bytes are staged, instead of copying them by 8-byte cp.async, hold the
backward to two blocks an SM instead of three, run the 16-byte copies of a
ragged head dim in a runtime loop, and take out the shift of staged rows,
or the whole pass that shifts them into place.

Usage: python -m ofb_tpu_torch.probe_kernels [resident] [streaming]
[unaligned] [general] (every body's variants without arguments). Needs a CUDA device and nvcc.
Copies and libraries go to build/ofb_tpu_torch_probe/ (git-ignored).
Prints one line a variant and round: its name, forward ms, backward ms,
the shape and the card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

# B, N, H, d at batch 256: DeiT-S at 224 and at 384 pixels; for the
# unaligned body also the offset of its views into wider rows (elements)
SHAPES = {"resident": (256, 197, 6, 64), "streaming": (256, 577, 6, 64),
          "unaligned": (256, 197, 6, 64, 1), "general": (256, 197, 6, 64)}
# variants timed at another shape than their body's
VARIANT_SHAPES = {n: (32, 257, 16, 80) for n in (
    "stream_vit_h", "stream_vit_h_no_narrow_last_tile",
    "stream_vit_h_no_d80_tail")} | {
    n: (256, 197, 6, 20, 0) for n in ("unaligned_d20", "unaligned_d20_staged",
                                      "unaligned_d20_4_byte_copies")}
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
STMA = "sm90_tma.cuh"
_TURNS = [(STMA, "  if (w == 1) bar_arrive(SCHED, 2 * WG);", ""),
          (STMA, "  bar_sync(SCHED + w, 2 * WG);\n", ""),
          (STMA, "  if (!(w == 1 && last)) bar_arrive(SCHED + (w ^ 1), 2 * WG);",
           "")]
_REGS = "constexpr int PRODUCER_REGS = 40;\nconstexpr int CONSUMER_REGS = 232;"
STREAMING_VARIANTS = {
    "streaming_as_committed": [],
    # the forward's ring of 128-key K, V stages: 2 and 5 instead of 4
    "stream_fwd_2_stages": [(SFWD, "  return TW <= 16 ? 4 : TW == 32 ? 3 : 2;",
                             "  return TW <= 16 ? 2 : TW == 32 ? 3 : 2;")],
    "stream_fwd_5_stages": [(SFWD, "  return TW <= 16 ? 4 : TW == 32 ? 3 : 2;",
                             "  return TW <= 16 ? 5 : TW == 32 ? 3 : 2;")],
    # the backward's rings at d16 <= 64: 4 stages of K, V (dq) and 4 of Q,
    # dO (dk/dv) instead of 6 and 8
    "stream_bwd_4_stages": [
        (SBWD, "  return TW == 0 ? 6 : TW == 16 ? 4 : 3;",
         "  return TW == 0 ? 4 : TW == 16 ? 4 : 3;"),
        (SBWD, "  return TW == 0 ? 8 : TW == 16 ? 6 : 4;",
         "  return TW == 0 ? 4 : TW == 16 ? 6 : 4;")],
    # the register split: producer 24, consumers 240
    "stream_regs_24_240": [(STMA, _REGS, _REGS.replace("40;", "24;").replace(
        "232;", "240;"))],
    # the backward's consumers issue as they come (no turns: ping-pong
    # off), and the forward's take turns (ping-pong on)
    "stream_no_pingpong": _TURNS,
    "stream_fwd_pingpong": [(SFWD, "constexpr bool TURNS = false;",
                             "constexpr bool TURNS = true;")],
    # s of tile t and e v of tile t - 1 waited for together (the forward's
    # and the dq kernel's pipelining inside a warpgroup off), and the dk/dv
    # kernel's products after its scores
    "stream_no_intra_wg_overlap": [
        (SFWD, "      wgmma_wait<1>();                       // s of tile t",
         "      wgmma_wait<0>();"),
        (SBWD, "      wgmma_wait<1>();\n      fence_regs(s);",
         "      wgmma_wait<0>();\n      fence_regs(s);"),
        (SBWD, "kv_pipelined() { return TW < 64; }",
         "kv_pipelined() { return false; }")],
    # ViT-H/14's shape (N = 257 = 2 * 128 + 1, d = 80): as committed, with
    # a full 128-key last tile instead of the 16-key one, and with d = 80
    # in 128 columns (no 16-column tail)
    "stream_vit_h": [],
    "stream_vit_h_no_narrow_last_tile": [
        (SFWD, "  const int narrow = rem == 0 ? 0 : rem <= 16 ? 1 : rem <= 80 ? 5 : 0;",
         "  const int narrow = 0;")],
    # DeiT-S-384 with a full 128-key last tile instead of the 80-key one
    "stream_fwd_no_narrow_last_tile": [
        (SFWD, "  const int narrow = rem == 0 ? 0 : rem <= 16 ? 1 : rem <= 80 ? 5 : 0;",
         "  const int narrow = 0;")],
    "stream_vit_h_no_d80_tail": [(STMA, "ks == 5 ? 16 :", "ks == 5 ? 64 :")],
    # diagnostics, outputs wrong: the forward without its exponentials
    # (ex2 -> its argument), without its e v products
    "stream_fwd_no_exp": [
        (SFWD, "const float x = ex2(fmaf(s[4 * j + c], LOG2E, -mx[c >> 1]));",
         "const float x = fmaf(s[4 * j + c], LOG2E, -mx[c >> 1]);")],
    # ... without its V loads, without its K and V loads (the ring's
    # barriers still complete; the tiles hold stale data)
    "stream_fwd_no_v_loads": [
        (SFWD, """        mbar_expect(v_full(s), TK::BYTES);
        tma_load(V, &maps.v, v_full(s), 0, KEYS * t, h, b);""",
         """        mbar_arrive(v_full(s));""")],
    "stream_fwd_no_kv_loads": [
        (SFWD, """        mbar_expect(v_full(s), TK::BYTES);
        tma_load(V, &maps.v, v_full(s), 0, KEYS * t, h, b);""",
         """        mbar_arrive(v_full(s));"""),
        (SFWD, """        mbar_expect(k_full(s), TK::BYTES);
        tma_load(K, &maps.k, k_full(s), 0, KEYS * t, h, b);""",
         """        mbar_arrive(k_full(s));""")],
    # ... without its q kᵀ products
    "stream_fwd_no_qk": [
        (SFWD, """        wgmma_ss(sw, desc_k<TW>(Q, 0, kk), desc_k<TW, KEYS>(stage(st), 0, kk),
                 kk > 0);""", """        (void)sw;""")],
    "stream_fwd_no_pv": [
        (SFWD, "        o.template mma<KEYS>(p[kk], V, 16 * kk, t > 0 || kk > 0);",
         "        (void)V;")],
}
_WIDTHS = "  for (int w = 16; w > 2; w /= 2) {"
_RAGGED_RUN = """  if constexpr (RAGGED) {
#pragma unroll
    for (int i = 0; i < ROWS * CPR / WG; ++i)
      copy(threadIdx.x / CPR + i * (WG / CPR));
  } else {
    for (int r = threadIdx.x / CPR; r < nrows; r += blockDim.x / CPR)
      copy(r);
  }"""
_RUNTIME_LOOP = """  for (int r = threadIdx.x / CPR; r < nrows; r += blockDim.x / CPR)
    copy(r);"""
UNALIGNED_VARIANTS = {
    "unaligned_as_committed": [],
    # the backward's registers held to two blocks an SM, not three
    "unaligned_bwd_two_blocks": [("attention_bwd_unaligned.cu",
                                  "return ks <= 4 ? 3 : 2;", "return 2;")],
    # head dim 20, rows on 8 bytes: by 8-byte cp.async, by 4-byte ones, and
    # staged as rows on 2 bytes are
    "unaligned_d20": [],
    "unaligned_d20_4_byte_copies": [("sm90.cuh", _WIDTHS, _WIDTHS.replace(
        "w /= 2", "w /= w == 16 ? 4 : 2"))],
    "unaligned_d20_staged": [("sm90.cuh", _WIDTHS,
                              _WIDTHS.replace("w > 2", "w > 8"))],
    # the 16-byte copies of a ragged head dim in one runtime loop, as the
    # resident body's, instead of an unrolled fixed run (registers at KS = 4)
    "unaligned_ragged_runtime_loop": [("sm90.cuh", _RAGGED_RUN, _RUNTIME_LOOP)],
    # diagnostics, outputs wrong: the staged rows taken unshifted, and not
    # shifted into place at all (no second barrier a tile)
    "unaligned_no_shift": [("sm90.cuh", "      const int sh = (o & 2) * 8;",
                            "      const int sh = 0;")],
    "unaligned_no_unstage": [
        ("attention_fwd_unaligned.cu", "    if (stage_k || stage_v) {",
         "    if (false) {"),
        ("attention_bwd_unaligned.cu", "    if (stage_k || stage_v) {",
         "    if (false) {"),
        ("attention_bwd_unaligned.cu", "    if (stage_q || stage_do) {",
         "    if (false) {")],
}
_GFWD = "OFB_FWD_F32(2, 8, 4, 2)"       # d <= 64: RM, warps, blocks an SM
_GBWD = "OFB_BWD_F32(2, 4, 4, 2)"
GENERAL_VARIANTS = {
    "general_as_committed": [],
    # the forward's 4 x 8 tiles: 64 rows of 4 warps, or 128 rows of 8
    "general_fwd_4x8": [("attention_fwd.cu", _GFWD,
                         "OFB_FWD_F32(2, 4, 4, 2)")],
    "general_fwd_4x8_8_warps": [("attention_fwd.cu", _GFWD,
                                 "OFB_FWD_F32(2, 4, 8, 2)")],
    # the backward's 8 x 8 tiles over 128 rows (one block an SM), and its
    # 4 x 8 tiles over 128 rows of 8 warps (one block an SM)
    "general_bwd_8x8": [("attention_bwd.cu", _GBWD,
                         "OFB_BWD_F32(2, 8, 4, 1)")],
    "general_bwd_4x8_8_warps": [("attention_bwd.cu", _GBWD,
                                 "OFB_BWD_F32(2, 4, 8, 1)")],
}
BODY_VARIANTS = {"resident": RESIDENT_VARIANTS,
                 "streaming": STREAMING_VARIANTS,
                 "unaligned": UNALIGNED_VARIANTS,
                 "general": GENERAL_VARIANTS}
_LIBS = {body: ("attention_fwd" + ("" if body == "general" else "_" + body),
                "attention_bwd" + ("" if body == "general" else "_" + body))
         for body in BODY_VARIANTS}


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

    B, N, H, d, *off = VARIANT_SHAPES.get(name, SHAPES[body])
    off = off[0] if off else 0
    dtype = torch.float32 if body == "general" else torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.randn((B, N, 3, H, d + off), generator=gen,
                      device="cuda").to(dtype)
    buf[:, :, 0] = (buf[:, :, 0].float() * d ** -0.5).to(dtype)
    q, k, v = (buf[:, :, i, :, off:] for i in range(3))
    if off == 0:
        q = q.contiguous()
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = A.attention_fwd(q, k, v, body=body)
    t_fwd = ms(lambda: A.attention_fwd(q, k, v, body=body))
    t_bwd = ms(lambda: A.attention_bwd(q, k, v, o, lse, do, body=body))
    print(f"{name:26s} fwd {t_fwd:.4f} ms  bwd {t_bwd:.4f} ms  "
          f"B={B} N={N} H={H} d={d} offset={off} {str(dtype)[6:]}  "
          f"[{card()}]",
          flush=True)


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
        for lib in _LIBS[body]:
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
