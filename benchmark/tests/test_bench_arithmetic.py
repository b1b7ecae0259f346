"""The frozen arithmetic: FLOPs from shapes by architecture, the attention
bounds and the interval arithmetic behind `device.idle` and
`nccl.exposed_ms`."""

import pytest
import torch

from benchmark import cells, flops, trace
from benchmark.trace import TracedWindow

# Swin-T (Liu et al. 2021; microsoft/Swin-Transformer
# swin_tiny_patch4_window7_224) in the keys of the port's `SwinCfg`
SWIN_T = {"arch": "swin", "img_size": 224, "patch_size": 4, "in_chans": 3,
          "num_classes": 1000, "embed_dim": 96, "depths": [2, 2, 6, 2],
          "num_heads": [3, 6, 12, 24], "window": 7, "mlp_ratio": 4.0,
          "search": {"attn": True, "mlp": True, "embed": True}}
# two stages whose sides (16, 8) are multiples of the window 4
SWIN_TINY = {"arch": "swin", "img_size": 32, "patch_size": 2, "in_chans": 3,
             "num_classes": 10, "embed_dim": 8, "depths": [2, 2],
             "num_heads": [2, 4], "window": 4, "mlp_ratio": 2.0}


# The ViT count as the cells' readings were taken with it, to the last bit:
# per image, train FLOPs and forward multiply-adds
@pytest.mark.parametrize("name, phase, train, fwd", [
    ("deit_s_ofb", "search", 28_094_251_008, 4_598_882_304),
    ("deit_ti", "finetune", 7_464_296_448, 1_253_683_200),
])
def test_the_vit_count_is_unchanged_to_the_bit(name, phase, train, fwd):
    cfg = cells.config(name)
    assert flops.train_flops_per_image(cfg, phase) == train
    assert sum(flops.forward_macs(cfg).values()) == fwd


@pytest.mark.parametrize("cfg, gmacs, rel", [
    (cells.config("deit_s_ofb"), 4.6, 0.01),
    (cells.config("deit_ti"), 1.3, 0.05),
    (cells.config("deit_b_ofb"), 17.6, 0.01),
    (SWIN_T, 4.5, 0.01),
], ids=["deit_s", "deit_ti", "deit_b", "swin_t"])
def test_forward_is_the_published_gmacs(cfg, gmacs, rel):
    assert sum(flops.forward_macs(cfg).values()) / 1e9 == \
        pytest.approx(gmacs, rel=rel)


@pytest.mark.parametrize("cfg, macs", [(SWIN_T, 4_490_566_656),
                                       (SWIN_TINY, None)],
                         ids=["swin_t", "two_stages"])
def test_the_swin_count_is_the_ports_forward_as_torch_counts_it(cfg, macs):
    from torch.utils.flop_counter import FlopCounterMode

    from ofb_tpu_torch.models.swin import Swin, SwinCfg, swin_forward
    keys = ("img_size", "patch_size", "in_chans", "num_classes", "embed_dim",
            "depths", "num_heads", "window", "mlp_ratio")
    scfg = SwinCfg(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                      else cfg[k] for k in keys})
    model = Swin(scfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, scfg.img_size, scfg.img_size, scfg.in_chans)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        swin_forward(model, x, scfg, compute_dtype=torch.float32)
    count = sum(flops.forward_macs(cfg).values())
    assert counter.get_total_flops() == 2 * count
    assert macs is None or count == macs


def test_swin_trains_as_the_vit_does_and_has_no_attention_calls():
    f = flops.forward_macs(SWIN_T)
    assert set(f) == {"patch", "blocks", "merge", "head"}
    assert flops.train_flops_per_image(SWIN_T, "search") == 2 * (
        2 * f["patch"] + 3 * (f["blocks"] + f["merge"] + f["head"]))
    assert flops.attention_calls(SWIN_T, 128) == []


@pytest.mark.parametrize("cfg, match", [
    (dict(SWIN_T, arch="mamba"), "'mamba'"),
    (dict(SWIN_T, img_size=192), "window"),
    (dict(SWIN_T, search={"decoder": True}), "decoder"),
], ids=["unknown_arch", "side_off_the_window", "swin_decoder"])
def test_what_has_no_count_raises(cfg, match):
    with pytest.raises(ValueError, match=match):
        flops.train_flops_per_image(cfg, "search")


def test_mfu_and_the_roofline_read_a_swin_cell():
    t = TracedWindow(events=[("sm90_xmma_gemm", 0.0, 5e5)],
                     spans=[("bench.call", 0.0, 1.0)], window=(0.0, 1e6),
                     calls=2, cell={"config": SWIN_T, "phase": "search",
                                    "rank_images_per_call": 1024,
                                    "rank_rows": 128,
                                    "microbatches_per_call": 8})
    # 2 (2 · 14,450,688 + 3 (4,301,939,712 + 173,408,256 + 768,000)) FLOPs
    # an image, 2048 images in the window's second
    share = 100 * 26_914_498_560 * 2048 / 989e12
    assert cells.metric_reader("mfu").read(t) == pytest.approx(share,
                                                               rel=1e-12)
    assert cells.metric_reader("attn.roofline").read(t) is None


def test_a_subnets_blocks_count_their_own_widths():
    cfg = dict(cells.config("deit_ti"), depth=2,
               block_overrides=[[2, 16, 384], [3, 64, 768]])
    D, N = cfg["embed_dim"], flops.tokens(cfg)
    blocks = sum(N * D * 3 * H * d + 2 * H * N * N * d + N * H * d * D
                 + 2 * N * D * hidden for H, d, hidden in [(2, 16, 384),
                                                            (3, 64, 768)])
    assert flops.forward_macs(cfg)["blocks"] == blocks


def test_train_flops_count_backward_twice_and_the_decoder():
    cfg = cells.config("deit_s_ofb")
    f = flops.forward_macs(cfg)
    dense = 2 * (3 * (f["blocks"] + f["head"]) + 2 * f["patch"])
    dec, targets = flops.decoder_macs(cfg)
    assert flops.train_flops_per_image(cfg, "finetune") == dense
    assert flops.train_flops_per_image(cfg, "search") == \
        dense + 2 * (3 * dec + targets)


# PERF.md §6's bounds (the kernel tables), the backward's bytes with o
# read too: 16 an element, not the tables' 14 (0.0809 and 0.0253 ms there)
@pytest.mark.parametrize("call, fwd_ms, bwd_ms", [
    ((256, 197, 6, 64), 0.0462, 0.0925),      # resident rows, bytes
    ((256, 577, 6, 64), 0.1355, 0.3309),      # streaming rows, operations
    ((256, 197, 6, 20), 0.0145, 0.0289),      # unaligned rows, bytes
])
def test_attention_bounds_are_the_kernel_tables(call, fwd_ms, bwd_ms):
    fwd, bwd = flops.attention_bound_s(call)
    assert fwd * 1e3 == pytest.approx(fwd_ms, abs=6e-5)
    assert bwd * 1e3 == pytest.approx(bwd_ms, abs=6e-5)


def test_attention_calls_follow_each_blocks_heads():
    cfg = dict(cells.config("deit_ti"), depth=2,
               block_overrides=[[4, 48, 384], [2, 56, 768]])
    assert flops.attention_calls(cfg, 256) == [(256, 197, 4, 48),
                                               (256, 197, 2, 56)]
    assert flops.attention_calls(cells.config("deit_ti"), 64) == \
        [(64, 197, 3, 64)] * 12


def test_interval_union_subtract_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)]
    assert trace.union(iv) == [(0, 3), (5, 7)]
    assert trace.length(iv) == 5
    assert trace.subtract([(0, 10)], iv) == [(3, 5), (7, 10)]
    assert trace.subtract([(2, 6)], [(0, 3), (4, 5)]) == [(3, 4), (5, 6)]
    assert trace.gaps(iv, (-1, 8)) == [(-1, 0), (3, 5), (7, 8)]
    assert trace.clip([(0, 4), (6, 9)], (2, 7)) == [(2, 4), (6, 7)]


def _window(events):
    spans = [("bench.call", 0.0, 1.0), ("bench.sync", 9.0, 10.0)]
    return TracedWindow(events=events, spans=spans, window=(0.0, 10.0),
                        calls=2, cell={})


def test_idle_share_takes_the_union_not_the_sum():
    t = _window([("gemm_a", 1, 5), ("elementwise", 2, 4), ("Memset", 6, 7)])
    idle = cells.metric_reader("device.idle").read(t)
    assert idle == pytest.approx(100 * (1 - 5 / 10))
    assert t.device_s() == pytest.approx(7e-6)


def test_exposed_nccl_is_what_no_other_kernel_covers():
    t = _window([("ncclDevKernel_AllReduce", 2, 8), ("sm90_xmma_gemm", 1, 3),
                 ("attention_fwd_resident_kernel", 5, 6)])
    got = cells.metric_reader("nccl.exposed_ms").read(t)
    assert got == pytest.approx((8 - 3 - 1) * 1e-6 / 2 * 1e3)
    assert cells.metric_reader("nccl.exposed_ms").read(
        _window([("gemm", 0, 1)])) is None


def test_kernel_classes_by_name():
    k = trace.kernel_class
    assert k("void attention_bwd_dq_resident_kernel<64>(...)") == "attention"
    assert k("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)") == "nccl"
    assert k("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "gemm"
    assert k("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN") == "gemm"
    assert k("Memcpy DtoD (Device -> Device)") == "memory"
    assert k("void at::native::vectorized_elementwise_kernel<4>") == "other"


def test_dispatch_leaves_out_the_hosts_waits_in_the_runtime():
    t = TracedWindow(events=[], spans=[("bench.call", 0.0, 10.0),
                                       ("bench.call", 12.0, 20.0),
                                       ("bench.readback", 20.0, 24.0),
                                       ("bench.sync", 24.0, 30.0)],
                     window=(0.0, 30.0), calls=2, cell={},
                     waits=[(2.0, 9.0), (13.0, 19.0), (21.0, 23.5),
                            (25.0, 29.0)])
    got = cells.metric_reader("engine.dispatch_ms").read(t)
    assert got == pytest.approx((3 + 2 + 1.5) * 1e-6 / 2 * 1e3)


def test_a_number_without_a_limit_is_not_compared():
    from benchmark import compare
    ok, checks = compare.judge({"loss_gap": 1.0, "grad_gap": 0.01},
                               {"grad_gap": 0.02})
    assert ok and list(checks) == ["grad_gap"]
    ok, _ = compare.judge({"loss_gap": 0.0, "grad_gap": float("nan")},
                          {"grad_gap": 0.02})
    assert not ok
