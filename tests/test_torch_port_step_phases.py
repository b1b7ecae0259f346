"""The step phases (ofb_tpu_torch/utils/profiling.py `step_phase`, placed
in core/steps.py) on the CPU, and on a card where there is one:

* under `torch.profiler` each train step records its `ofb.step.*` ranges
  in order: the search step (A = 2) `input`, (`forward`, `loss`,
  `backward`) x 2, `update`; with Mixup (postsearch, finetune) an `input`
  more in each microbatch; a planned step adds its own `input` (index,
  schedules, gather) before the inner step's and its own `update` (the
  output) after;
* a step with its phases runs on the CPU without building or loading a
  CUDA library;
* the phases change no number: loss and every tensor of the state after
  one update are bit-equal with `step_phase` replaced by a null context;
* the mark kernels' source holds one begin and one end kernel a phase,
  in `PHASES`' order, named so that no reader takes them for another kind
  of kernel;
* (`card`, skipped without one) a planned step captured as a CUDA graph
  runs every mark once per phase entry in each replay, begin before end,
  in the order the CPU records the ranges.

The card tests, on a card (this file imports no JAX):
`python3 -m pytest --noconftest -m card tests/test_torch_port_step_phases.py`
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from ofb_tpu_torch.config import (MixupConfig, OptimFamilyConfig,
                                  ScheduleConfig, SearchConfig)
from ofb_tpu_torch.core import steps as S
from ofb_tpu_torch.core.lr_decay import build_finetune_optimizer
from ofb_tpu_torch.core.optim import (build_search_optimizer, make_schedule,
                                      named_leaves)
from ofb_tpu_torch.models.mim_vit import Alphas, MimViT
from ofb_tpu_torch.models.search_space import ArchState, SearchSpace
from ofb_tpu_torch.models.vit import ModelCfg, ViT
from ofb_tpu_torch.ops import cuda_build
from ofb_tpu_torch.utils import profiling as P

torch.set_num_threads(1)
CFG = dict(img_size=16, patch_size=4, num_classes=4, embed_dim=32, depth=1,
           num_heads=2, mlp_ratio=2.0, drop_path_rate=0.0)
STAGING = 20            # the cache's staging size, above the input size
N, BS, STEPS, A = 64, 8, 8, 2
AUG = dict(use_randaug=False, re_prob=0.0, hflip=True)
MIX = MixupConfig(mixup=0.8, cutmix=1.0)
MICRO = ["forward", "loss", "backward"]
PHASE_ORDER = {
    "search": ["input"] + MICRO * A + ["update"],
    "postsearch": ["input"] + (["input"] + MICRO) * A + ["update"],
    "finetune": ["input"] + (["input"] + MICRO) * A + ["update"],
    "planned_search": ["input", "input"] + MICRO * A + ["update", "update"],
    "planned_finetune": ["input", "input"] + (["input"] + MICRO) * A
    + ["update", "update"],
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def _data(dev):
    rng = np.random.default_rng(3)
    cache = rng.integers(0, 256, (N, STAGING, STAGING, 3)).astype(np.uint8)
    labels = rng.integers(0, CFG["num_classes"], (N,)).astype(np.int64)
    batches = rng.permutation(N)[:STEPS * BS].reshape(STEPS, BS)
    return torch.from_numpy(cache).to(dev), labels, batches


def _search_state(dev):
    cfg = ModelCfg(**CFG)
    space = SearchSpace.build(cfg.embed_dim, cfg.depth, cfg.num_heads,
                              cfg.hidden, cfg.num_patches, patch_search=True)
    g = torch.Generator().manual_seed(0)
    params = MimViT(cfg, space, generator=g).to(dev)
    alphas = Alphas(space, generator=g).to(dev)
    scfg = SearchConfig(
        accum_iter=A, target_flops=0.0002,
        schedule=ScheduleConfig(warmup_epochs=2),
        optim_param=OptimFamilyConfig(lr=1e-3),
        optim_decoder=OptimFamilyConfig(lr=1e-3),
        optim_arch=OptimFamilyConfig(lr=1e-3, betas=(0.5, 0.999))).resolve(1)
    tx = build_search_optimizer(
        scfg.optim_param, scfg.optim_arch, scfg.optim_decoder, scfg.schedule,
        total_steps=1000, steps_per_epoch=STEPS * A, accum_iter=A)[0]
    state = S.TrainState(step=0, params=params, alphas=alphas,
                         arch=ArchState.create(space, dev),
                         opt_state=tx.init(named_leaves(params, alphas)))
    return cfg, space, scfg, tx, state


def _train_state(dev):
    cfg = ModelCfg(**CFG)
    params = ViT(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    # a schedule of device tensors, as a captured step needs
    lr = make_schedule(1e-3, ScheduleConfig(warmup_epochs=1), 1000,
                       STEPS * A)
    tx = build_finetune_optimizer(params, lr_schedule=lambda c: lr(c * A),
                                  num_layers=1, clip_grad=1.0)
    state = S.TrainState(step=0, params=params, alphas=None, arch=None,
                         opt_state=tx.init(dict(params.named_parameters())),
                         ema_params={n: p.detach().clone() for n, p
                                     in params.named_parameters()})
    return cfg, tx, state


def step_call(kind, dev=torch.device("cpu"), dtype=torch.float32):
    """(state, call) of one tiny train step of `kind` (PHASE_ORDER's keys)
    on `dev`: `call()` takes one step and returns its loss."""
    cache, labels, batches = _data(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    if kind.endswith("search"):
        cfg, space, scfg, tx, state = _search_state(dev)
    else:
        cfg, tx, state = _train_state(dev)
    if kind.startswith("planned"):
        if kind == "planned_search":
            pstep, keys = S.make_planned_search_step(
                space, cfg, scfg, tx, phase="search", steps_per_epoch=STEPS,
                compute_dtype=dtype, device=dev, **AUG)
            at = list(keys).index("loss_total")
        else:
            pstep = S.make_planned_train_step(
                cfg, tx, num_classes=CFG["num_classes"], accum_iter=A,
                mixup_cfg=MIX, ema_decay=0.99, compute_dtype=dtype,
                device=dev, **AUG)
            at = 0
        plan = pstep.load_plan(batches, labels, 0, state.step)
        args = plan[:2] + (gen, plan[2]) \
            + ((plan[3],) if kind == "planned_search" else ())

        def call():
            _, out = pstep(state, cache, *args)
            return out.reshape(-1)[at]
        call.pstep = pstep
        return state, call

    images = cache[torch.from_numpy(batches[0])].reshape(
        A, BS // A, STAGING, STAGING, 3)
    lbls = torch.from_numpy(labels[batches[0]]).reshape(A, BS // A).to(dev)
    if kind == "finetune":
        step = S.make_train_step(cfg, tx, num_classes=CFG["num_classes"],
                                 mixup_cfg=MIX, ema_decay=0.99,
                                 compute_dtype=dtype, fused_augment=True,
                                 device=dev, **AUG)
        return state, lambda: step(state, images, lbls, gen)[1]["loss"]
    step = S.make_search_step(space, cfg, scfg, tx, phase=kind,
                              compute_dtype=dtype, fused_augment=True,
                              device=dev, **AUG)
    return state, lambda: step(state, images, lbls, gen, 0.75)[1][
        "loss_total"]


def recorded_phases(call):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith(P.RANGE_PREFIX))
    return [n[len(P.RANGE_PREFIX):] for _, n in ranges]


@pytest.mark.parametrize("kind", list(PHASE_ORDER))
def test_a_step_records_its_phases_in_order(kind):
    _, call = step_call(kind)
    assert recorded_phases(call) == PHASE_ORDER[kind]


def test_phases_on_the_cpu_build_and_load_no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA library was built or loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    P.load_step_marks.cache_clear()
    for kind in ("search", "planned_finetune"):
        _, call = step_call(kind)
        assert torch.isfinite(call())
    assert P.load_step_marks.cache_info().currsize == 0


@pytest.mark.parametrize("kind", ["search", "planned_finetune"])
def test_phases_change_no_number(kind, monkeypatch):
    runs = []
    for null in (False, True):
        if null:
            monkeypatch.setattr(S, "step_phase",
                                lambda name: contextlib.nullcontext())
        state, call = step_call(kind)
        loss = call()
        runs.append((loss, dict(S.named_tensors(state))))
    (l0, t0), (l1, t1) = runs
    assert torch.equal(l0, l1)
    assert list(t0) == list(t1)
    for name in t0:
        assert torch.equal(t0[name], t1[name]), name


def test_step_phase_refuses_a_name_it_does_not_know():
    with pytest.raises(ValueError, match="step phase 'optimizer'"):
        with P.step_phase("optimizer"):
            pass
    with P.step_phase("loss"):
        pass


def test_the_mark_kernels_are_the_phases_by_name():
    src = (cuda_build.CSRC / cuda_build.SOURCES["step_marks"]).read_text()
    listed = re.search(r"#define OFB_PHASES\(X\) (.*)", src).group(1)
    assert re.findall(r"X\((\w+)\)", listed) == list(P.PHASES)
    assert 'extern "C" int ofb_step_mark(int phase, int edge' in src
    assert 'extern "C" int ofb_step_marks_load()' in src
    assert P.STEP_RANGES == tuple(f"ofb.step.{p}" for p in P.PHASES)
    # names a trace reader classes as attention, NCCL, GEMM or memory
    other = ("attention_", "nccl", "gemm", "nvjet", "xmma", "cutlass",
             "cublas", "memcpy", "memset")
    for p in P.PHASES:
        for edge in ("begin", "end"):
            name = f"ofb_mark_{p}_{edge}"
            assert not any(o in name.lower() for o in other), name
    assert not any(r.startswith("bench.") for r in P.STEP_RANGES)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["planned_search", "planned_finetune"])
def test_a_replayed_graph_runs_every_mark_in_order(card, kind):
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    _, call = step_call(kind, card, torch.bfloat16)
    for _ in range(S.PlannedStep.WARMUP + 1):      # eager, then the capture
        call()
    torch.cuda.synchronize(card)
    assert call.pstep.captures == 1
    replays = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            call()
        torch.cuda.synchronize(card)
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.device_type == cuda and "ofb_mark_" in e.name)
    got = [re.search(r"ofb_mark_([a-z]+_(?:begin|end))", n).group(1)
           for _, n in marks]
    want = [f"{p}_{edge}" for p in PHASE_ORDER[kind]
            for edge in ("begin", "end")]
    assert got == want * replays
    # a replay runs no Python: no range of the step is recorded
    assert not any(e.name.startswith(P.RANGE_PREFIX) for e in prof.events())
