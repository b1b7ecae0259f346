"""Train, search and eval steps.

Port of ofb_tpu/core/steps.py. `make_search_step` builds the supernet's
step; one call is one optimizer update over A accumulated microbatches:

  * per microbatch: the gated supernet forward, the loss families, then
    backward. Phase 'search': PMIM (token mask and decoder),
    label-smoothing CE, the arch loss (sparsity + FLOPs) and the decoder
    loss weighted by w_dec = base / dec (detached). Phase 'postsearch':
    MIM off, Mixup / CutMix with soft-target CE, no arch loss, the decoder
    and the mask token frozen;
  * gradients and metrics averaged over the A microbatches, `grad_norm` of
    the weight gradients;
  * the five-family AdamW, then the static update masks, the freeze of
    finished alphas and (postsearch) of the decoder, all applied to the
    updates after Adam moved every moment;
  * EMA of the weights when the state carries one; `step += A`.

`make_train_step` is the plain supervised step of the finetune stage on a
dense ViT (an exported subnet), `make_eval_step` / `make_eval_step_dense`
return the sums a caller averages over an epoch.

PyTorch runs eagerly, so the steps update the state's parameters, moments,
EMA, step counter and the optimizer's update count in place (no copy of the
model per step) and return the same state. Randomness never has to come
from the step: `token_masks=` replaces the PMIM masks, `mixup_draws=` the
Mixup parameters and `augment_draws=` the train transform's parameters
drawn from `generator`. With fused_augment=True a step takes uint8 staging
batches and runs the train transform (`ops/augment.py`) on the device
before the forward. A `teacher_apply(images) -> logits` adds the
distillation loss of `scfg.distillation` (search) or `distill` (train).

Under a process group (`parallel/`) the steps are data parallel: each rank
takes its rows of the global batch, every random draw is the global
batch's (`parallel.mesh.draw_rows`) and randomness handed in is the global
microbatch's, of which the step takes this rank's rows; Mixup pairs across
ranks; the decoder weight, the gradients and the metrics are the global
batch's (`_accumulate`'s all-reduce). A world of N then takes the step one
process takes on the concatenated batch.

On a (data, model) mesh (`parallel.mesh.make_mesh`, the active one) the
step runs tensor parallel on a supernet cut into model-axis shards by
`parallel.mesh.shard_params`, the batch split over the data axis. Every collective above then runs over the
data group only (the ranks of a model group hold the same rows), the
forward's over the model group (`parallel/tensor_parallel.py`), and the
gradient norm and the clip count each sharded leaf's square sum once,
summed over the model group. It is the step one process takes on the
whole supernet and the concatenated batch, as the JAX package's SPMD step
on a (dp, tp) mesh is.

`make_planned_search_step` / `make_planned_train_step` are the steps of the
planned epoch: the epoch's index plan on the device, everything of an
iteration (the schedules, the gather from the uint8 cache, the augment, the
step) computed there from the state's step counter, so no host number
enters a step. On the card they run as a `PlannedStep`, a CUDA graph
captured once and replayed every iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import SearchConfig
from ..device import resolve_device
from ..models.mim_vit import Alphas, mim_forward
from ..models.search_space import ArchState, SearchSpace
from ..models.vit import ModelCfg, ViT, vit_forward
from ..ops.augment import apply_train_augment, draw_train_augment
from ..ops.mixup import apply_mixup, mixup_draws as draw_mixup
from ..parallel.distributed import (all_mean_, data_group, gather_rows,
                                    model_rank_world)
from ..parallel.mesh import draw_rows, sharded_names, this_rank_rows
from . import losses as L
from .optim import global_norm, named_leaves

METRIC_KEYS_SEARCH = ("loss_param", "loss_total", "loss_arch",
                      "loss_decoder", "searched_gflops", "grad_norm")
METRIC_KEYS_POSTSEARCH = ("loss_param", "loss_total", "grad_norm")


@dataclass
class TrainState:
    step: Any                          # micro-iterations: 0-d int64 tensor
    params: ViT                        # MimViT in the search, ViT in finetune
    alphas: Optional[Alphas]
    arch: Optional[ArchState]
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        # a device tensor the steps advance in place (an int is taken), so
        # that a captured step reads and writes the same counter
        if not isinstance(self.step, torch.Tensor):
            dev = next(self.params.parameters()).device
            self.step = torch.tensor(int(self.step), dtype=torch.int64,
                                     device=dev)


def _finished_alpha_names(alphas: Alphas, arch: ArchState):
    """(alpha leaf name, finished flag) pairs: a converged module's alpha
    gets no update (the reference stops its gradient, which also stops
    weight decay from drifting it)."""
    yield "alphas.patch", arch.patch.finished
    yield "alphas.embed", arch.embed.finished
    for s, d in enumerate(arch.stage_embeds):
        yield f"alphas.stage_embeds.{s}", d.finished
    for i, b in enumerate(arch.blocks):
        yield f"alphas.blocks.{i}.attn", b.attn.finished
        yield f"alphas.blocks.{i}.mlp", b.mlp.finished


def _is_decoder(name: str) -> bool:
    return name.startswith("decoder.") or name == "mask_token"


def _augmenter(fused_augment, out_size, use_randaug, re_prob, crop_scale,
               hflip):
    """augment(images_u8 (A, mb, S, S, 3), generator, draws, dev) -> float
    (A, mb, out, out, 3) on dev, the train transform of each microbatch
    with its draws (one `AugmentDraws` per microbatch) or with draws from
    `generator`; None when the step takes ready images."""
    if not fused_augment:
        return None

    def augment(images, generator, draws, dev):
        if draws is None and generator is None:
            raise ValueError("fused augmentation needs a `generator` to draw "
                             "from, or `augment_draws`")
        out = []
        for a in range(images.shape[0]):
            x = images[a].to(dev)
            d = this_rank_rows(draws[a]) if draws is not None else draw_rows(
                lambda n: draw_train_augment(
                    generator, n, x.shape[1], out_size,
                    use_randaug=use_randaug, re_prob=re_prob,
                    crop_scale=crop_scale, hflip=hflip, device=dev),
                x.shape[0])
            out.append(apply_train_augment(x, d, out_size=out_size))
        return torch.stack(out)

    return augment


def _mixed(images, labels, generator, draws, mix, *, num_classes,
           mixup_alpha, cutmix_alpha):
    """Mixup / CutMix of one microbatch: with the draws handed in, else
    with draws from `generator` (which must then be given). Each image's
    partner is its mirror in the global microbatch (row B-1-i), so under
    data parallelism the ranks gather the global microbatch, mix it with
    the global batch's draws and keep their own rows."""
    images = gather_rows(images, group=data_group())
    labels = gather_rows(labels, group=data_group())
    if draws is None:
        if generator is None:
            raise ValueError("Mixup needs a `generator` to draw from, or "
                             "`mixup_draws`")
        B, H, W, _ = images.shape
        draws = draw_mixup(generator, B, H, W, mixup_alpha=mixup_alpha,
                           cutmix_alpha=cutmix_alpha,
                           cutmix_minmax=mix.cutmix_minmax, prob=mix.prob,
                           switch_prob=mix.switch_prob, mode=mix.mode,
                           device=images.device)
    images, labels = apply_mixup(images, labels, draws,
                                 num_classes=num_classes, mode=mix.mode,
                                 label_smoothing=mix.label_smoothing)
    return this_rank_rows(images), this_rank_rows(labels)


def _accumulate(leaves, A, micro):
    """Run `micro(a)` -> (loss, metrics) and backward for a in range(A);
    returns ({name: mean gradient}, {metric: mean}). A leaf no microbatch
    reached gets a zero gradient (Adam still decays its moments). Under a
    process group the gradients and metrics are then averaged over the
    ranks of the data axis, in one flat all-reduce: every rank holds the
    global batch's mean, as JAX's replicated step does."""
    for p in leaves.values():
        p.grad = None
    sums: Dict[str, torch.Tensor] = {}
    for a in range(A):
        total, m = micro(a)
        total.backward()
        for k, v in m.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    grads = dict(zip(leaves, torch._foreach_div(
        [p.grad if p.grad is not None else torch.zeros_like(p)
         for p in leaves.values()], float(A))))
    metrics = {k: v / A for k, v in sums.items()}
    all_mean_(list(grads.values()) + list(metrics.values()),
              group=data_group())
    return grads, metrics


def _apply(leaves, updates, ema_params, params, ema_decay):
    """leaves += updates, clear the gradients, advance the EMA."""
    names = list(leaves)
    torch._foreach_add_(list(leaves.values()), [updates[n] for n in names])
    for p in leaves.values():
        p.grad = None
    if ema_params is not None and ema_decay is not None:
        ema, live = zip(*((ema_params[n], p)
                          for n, p in params.named_parameters()))
        torch._foreach_mul_(list(ema), ema_decay)
        torch._foreach_add_(list(ema), list(live), alpha=1.0 - ema_decay)


def make_search_step(space: SearchSpace, mcfg: ModelCfg, scfg: SearchConfig,
                     tx, *, phase: str = "search",
                     param_mask: Optional[Dict[str, float]] = None,
                     alpha_mask: Optional[Dict[str, float]] = None,
                     teacher_apply=None, compute_dtype=torch.bfloat16,
                     fused_augment: bool = False, use_randaug: bool = True,
                     re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                     hflip: bool = True, fused_model: bool = False,
                     gate_fold: bool = True, device="cuda"):
    """Build the supernet's step on `device` (default "cuda"; raises
    without a card unless device="cpu" is asked for). On the active mesh
    (`parallel.mesh.make_mesh`) a supernet cut by `shard_params` steps
    tensor parallel; each rank hands in its data-axis rows.

    Returns step(state, images (A, mb, H, W, C), labels (A, mb), generator,
    keep_ratio, token_masks=None, mixup_draws=None, augment_draws=None) ->
    (state, metrics). `token_masks` (A, mb, L), 1 = removed, replaces the
    PMIM masks drawn from `generator`; `mixup_draws`, one
    `ops.mixup.mixup_draws` result per microbatch, replaces the postsearch
    phase's Mixup draws. With `fused_augment` the images are uint8 staging
    batches (A, mb, S, S, 3), transformed to the model's input size on the
    device (`use_randaug`, `re_prob`, `crop_scale`, `hflip` as in
    `ops.augment.draw_train_augment`); `augment_draws`, one `AugmentDraws`
    per microbatch, replaces the draws from `generator`. `param_mask` /
    `alpha_mask` are `make_trainable_mask`'s static 0/1 update masks;
    `fused_model` runs a post-fuse supernet (gates off); `teacher_apply`
    (images -> fp32 logits, frozen) adds `scfg.distillation`'s loss on the
    images the student saw."""
    if phase not in ("search", "postsearch"):
        raise ValueError(f"phase {phase!r} (search | postsearch)")
    dev = resolve_device(device)
    augment = _augmenter(fused_augment, mcfg.img_size, use_randaug, re_prob,
                         crop_scale, hflip)
    use_mim = phase == "search"
    dcfg = scfg.distillation
    smoothing = scfg.mixup.label_smoothing
    static_mask = {**(param_mask or {}), **(alpha_mask or {})}

    def loss_fn(state: TrainState, images, labels, generator, keep_ratio,
                token_mask, draws):
        soft = False
        if phase == "postsearch":
            # the finish_search transition turns on Mixup(0.8) / CutMix(1.0)
            # and the soft-target CE
            images, labels = _mixed(
                images, labels, generator, draws, scfg.mixup,
                num_classes=mcfg.num_classes, mixup_alpha=0.8,
                cutmix_alpha=1.0)
            soft = True
        out = mim_forward(state.params, state.alphas, state.arch, images,
                          mcfg, space, train=True, use_mim=use_mim,
                          fused=fused_model, keep_ratio=keep_ratio,
                          generator=generator, token_mask=token_mask,
                          gate_fold=gate_fold, compute_dtype=compute_dtype)
        if out.logits_dist is not None:
            base = L.distilled_pair_loss(out.logits, out.logits_dist, labels,
                                         soft_labels=soft,
                                         smoothing=smoothing)
            kd_logits = out.logits_dist
        else:
            base = L.base_criterion(out.logits, labels, soft_labels=soft,
                                    smoothing=smoothing)
            kd_logits = out.logits
        if teacher_apply is not None and dcfg.distillation_type != "none":
            # the teacher sees the images the student saw (mixed after the
            # finish)
            base = L.distillation_loss(
                base, kd_logits, teacher_apply(images),
                kind=dcfg.distillation_type, alpha=dcfg.alpha, tau=dcfg.tau)
        metrics = {"loss_param": base}
        total = base
        if phase == "search":
            arch_loss, aux = L.ofb_arch_loss(
                state.params, state.alphas, state.arch, space, mcfg,
                target_flops=scfg.target_flops, w_head=scfg.w_head,
                w_mlp=scfg.w_mlp, w_patch=scfg.w_patch,
                w_embedding=scfg.w_embedding, w_flops=scfg.w_flops,
                entropy=scfg.entropy, var=scfg.var, norm=scfg.norm)
            dec = out.decoder_loss
            # dynamic decoder weight w = base / dec of the global batch
            # (the ranks' means averaged); its gradient flows into the
            # decoder loss only
            pair = torch.stack([base, dec]).detach()
            all_mean_([pair], group=data_group())
            w_dec = torch.where(pair[1] > 0,
                                pair[0] / pair[1].clamp_min(1e-12), 0.0)
            total = total + arch_loss + w_dec * dec
            metrics.update(loss_arch=arch_loss, loss_decoder=dec,
                           searched_gflops=aux["searched_gflops"])
        metrics["loss_total"] = total
        return total, metrics

    def step(state: TrainState, images, labels, generator=None,
             keep_ratio=None, token_masks=None, mixup_draws=None,
             augment_draws=None):
        A = images.shape[0]
        images = augment(images, generator, augment_draws, dev) \
            if augment is not None else images.to(dev)
        labels = labels.to(dev)
        leaves = named_leaves(state.params, state.alphas)
        sharded = set(sharded_names(state.params, leaves))

        def micro(a):
            return loss_fn(
                state, images[a], labels[a], generator, keep_ratio,
                this_rank_rows(token_masks[a]) if token_masks is not None
                else None,
                mixup_draws[a] if mixup_draws is not None else None)

        grads, metrics = _accumulate(leaves, A, micro)
        weights = [n for n in grads if not n.startswith("alphas.")]
        metrics["grad_norm"] = global_norm(
            [grads[n] for n in weights], [n in sharded for n in weights])

        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves, sharded)
            for n, m in static_mask.items():
                if m != 1.0:
                    updates[n] = updates[n] * m
            for n, f in _finished_alpha_names(state.alphas, state.arch):
                updates[n] = updates[n] * (1.0 - f.float())
            if phase == "postsearch":
                for n in updates:
                    if _is_decoder(n):
                        updates[n] = torch.zeros_like(updates[n])
            _apply(leaves, updates, state.ema_params, state.params,
                   scfg.model_ema_decay)
        state.step += A
        return state, metrics

    return step


def _anneal(frac_epoch, warmup_epochs: float, start: float, end: float):
    """start -> end linearly over the warmup, clamped, in fp32. A tensor
    `frac_epoch` (the planned step's) gives a 0-d tensor on its device with
    the multiply-add rounded once, as the compiled planned step of the JAX
    package fuses it; a number gives a float rounded twice, as JAX's host
    call computes it."""
    f = torch.as_tensor(frac_epoch).to(torch.float32)
    t = (f / max(float(warmup_epochs), 1e-8)).clamp_max(1.0)
    if isinstance(frac_epoch, torch.Tensor):
        return torch.addcmul(torch.full_like(t, start), t,
                             torch.full_like(t, end - start))
    return float(start + (end - start) * t)


def w_p_schedule(frac_epoch, warmup_epochs: float, w_max: float = 0.99,
                 w_min: float = 0.1):
    """Clamped bi-mask anneal value, w_max -> w_min over the warmup, in
    fp32 arithmetic (what `ArchState.w_p` holds); see `_anneal`."""
    return _anneal(frac_epoch, warmup_epochs, w_max, w_min)


@functools.lru_cache(maxsize=8)
def _patch_ratios(ratios: Tuple[float, ...], device: torch.device):
    """The patch cells' keep ratios on `device`, copied there once."""
    return torch.tensor(ratios, dtype=torch.float32, device=device)


def keep_ratio_schedule(frac_epoch, scfg: SearchConfig, arch: ArchState,
                        space: SearchSpace):
    """PMIM keep ratio: the progressive linear anneal max -> min over the
    warmup (a float, or a 0-d tensor for a tensor `frac_epoch`), or,
    non-progressive, the smallest active patch cell's ratio (a 0-d tensor
    computed from device state, no readback)."""
    if scfg.progressive:
        return _anneal(frac_epoch, scfg.schedule.warmup_epochs,
                       scfg.max_ratio, scfg.min_ratio)
    sw = arch.patch.switch
    return torch.where(sw, _patch_ratios(tuple(space.patch.ratios),
                                         sw.device), 1.0).min()


# ---------------------------------------------------------------------------
# Planned steps: the epoch's plan on the device, one graph replay a step
# ---------------------------------------------------------------------------

def named_tensors(obj, prefix: str = ""):
    """(dotted name, tensor) of every tensor below `obj`: modules (their
    parameters and buffers), dicts, sequences and dataclasses (a
    `TrainState`: step, params, alphas, arch, opt_state, ema_params)."""
    def sub(key):
        return f"{prefix}.{key}" if prefix else str(key)

    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, torch.nn.Module):
        for n, t in obj.named_parameters():
            yield sub(n), t
        for n, t in obj.named_buffers():
            yield sub(n), t
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from named_tensors(v, sub(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from named_tensors(v, sub(i))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from named_tensors(getattr(obj, f.name), sub(f.name))


class PlannedStep:
    """A planned step and the device buffers of its epoch plan.

    `step(state, cache, idx_plan, labels_plan, generator, epoch_base,
    epoch?)` runs `fn` on the same arguments. On the CPU it runs eagerly.
    On the card its first `WARMUP` calls run eagerly (real steps: they
    build the kernels and the library handles a capture needs); the next
    call captures `fn` as a CUDA graph, drawing from `generator` (registered
    with the graph), and that call and every later one replay it. A replay
    reads and writes the tensors the capture saw, so every call must hand
    over tensors in the same storage: the state is updated in place
    (optimizer, counters, `compress`), the plan goes through `load_plan`,
    and a call whose tensors moved raises. A capture that fails raises too;
    nothing falls back to the eager step. The attention wrappers' launch
    counts get the captured launches (`launches_per_replay`, {(wrapper,
    body): n}) at each replay, since a replay runs no Python. Returns
    (state, output) with the output cloned, as the next replay rewrites the
    graph's own."""

    WARMUP = 2

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.launches_per_replay = None
        self._graph = None
        self._out = None
        self._keys = None
        self._plan = None

    def load_plan(self, batches, labels: np.ndarray, epoch: int,
                  epoch_base: torch.Tensor):
        """Copy one epoch's index plan (steps, batch), its labels, the epoch
        and the step counter at its start into the step's device buffers
        (made at the first epoch; a later plan must have the same shape).
        Returns (idx_plan, labels_plan, epoch_base, epoch) to pass on."""
        idx = np.asarray(batches, np.int64)
        src = (torch.from_numpy(idx),
               torch.from_numpy(np.asarray(labels)[idx].astype(np.int64)),
               epoch_base.detach().to(torch.int64),
               torch.tensor(int(epoch), dtype=torch.int64))
        if self._plan is None:
            self._plan = tuple(torch.empty(t.shape, dtype=torch.int64,
                                           device=self.device) for t in src)
        for buf, t in zip(self._plan, src):
            if buf.shape != t.shape:
                raise ValueError(f"an epoch plan of shape {tuple(t.shape)} "
                                 f"after {tuple(buf.shape)}: a planned step "
                                 "keeps its plan's shape")
            buf.copy_(t)
        return self._plan

    def _signature(self, args):
        return [(id(a) if isinstance(a, torch.Generator) else None)
                for a in args] + [t.data_ptr() for _, t in named_tensors(args)]

    def __call__(self, *args):
        if self.device.type != "cuda" or (self._graph is None
                                          and self.calls < self.WARMUP):
            self.calls += 1
            return self.fn(*args)
        if self._graph is None:
            self._capture(args)
        elif self._signature(args) != self._keys:
            raise RuntimeError("a captured planned step was handed tensors "
                               "in new storage: the state and the plan must "
                               "be updated in place")
        from ..ops.attention import add_launches
        self._graph.replay()
        add_launches(self.launches_per_replay)
        self.calls += 1
        self.replays += 1
        return args[0], self._out.clone()

    def _capture(self, args):
        from ..ops.attention import add_launches, launch_counts
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        default = torch.cuda.default_generators[
            self.device.index if self.device.index is not None
            else torch.cuda.current_device()]
        for a in args:
            if isinstance(a, torch.Generator) and a is not default:
                graph.register_generator_state(a)
        before = launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            _, out = self.fn(*args)
        # the capture recorded the launches; they run at each replay
        self.launches_per_replay = {k: n - before[k]
                                    for k, n in launch_counts().items()}
        add_launches({k: -n for k, n in self.launches_per_replay.items()})
        self._graph, self._out = graph, out
        self._keys = self._signature(args)
        self.captures += 1


def _refuse_gloo_capture(device) -> None:
    """Raise for a tensor-parallel planned step on the card under gloo (a
    model axis above one on the active mesh): its forward's collectives
    run in every replay, and gloo's stage card tensors through the host,
    which a CUDA graph cannot capture."""
    import torch.distributed as dist
    if resolve_device(device).type != "cuda":
        return
    if model_rank_world()[1] > 1 and dist.get_backend() == "gloo":
        raise ValueError("a tensor-parallel planned step on the card needs "
                         "NCCL: a CUDA graph cannot capture gloo's "
                         "collectives (use make_search_step, or NCCL)")


def _gather(cache, idx_plan, labels_plan, it, A: int):
    """Row `it` of the plan: the uint8 cache rows and labels, as A
    microbatches."""
    row = it.reshape(1)
    idx = idx_plan.index_select(0, row)[0]
    lbls = labels_plan.index_select(0, row)[0]
    imgs = cache.index_select(0, idx)
    mb = idx.shape[0] // A
    return imgs.reshape(A, mb, *imgs.shape[1:]), lbls.reshape(A, mb)


def make_planned_search_step(space: SearchSpace, mcfg: ModelCfg,
                             scfg: SearchConfig, tx, *, phase: str,
                             steps_per_epoch: int,
                             param_mask: Optional[Dict[str, float]] = None,
                             alpha_mask: Optional[Dict[str, float]] = None,
                             teacher_apply=None,
                             compute_dtype=torch.bfloat16,
                             use_randaug: bool = True, re_prob: float = 0.25,
                             crop_scale=(0.08, 1.0), hflip: bool = True,
                             fused_model: bool = False, device="cuda"):
    """The search step over the device-resident cache, everything of an
    iteration on the device. Returns (step, metric keys):

      step(state, cache, idx_plan, labels_plan, generator, epoch_base,
           epoch) -> (state, packed metrics)

    idx_plan / labels_plan (steps_per_epoch, A * mb) and the 0-d epoch_base
    (the step counter at the epoch's start) and epoch are device tensors
    (`PlannedStep.load_plan`). The iteration index comes from the state's
    step counter; from it the step computes the fraction of the epoch done,
    writes the w_p anneal into the unfinished modules, takes the PMIM keep
    ratio, gathers the uint8 cache rows and labels of the iteration, runs
    the fused augment and the inner step (`make_search_step`, drawing from
    `generator` in the same order) and packs the metrics into one fp32
    vector in the keys' order. On the card the step is a `PlannedStep`:
    replayed as a CUDA graph. On the card a tensor-parallel step (the
    active mesh's model axis above one) is captured under NCCL only (a
    CUDA graph cannot hold gloo's host-staged collectives), and refused
    under gloo."""
    _refuse_gloo_capture(device)
    inner = make_search_step(
        space, mcfg, scfg, tx, phase=phase, param_mask=param_mask,
        alpha_mask=alpha_mask, teacher_apply=teacher_apply,
        compute_dtype=compute_dtype, fused_augment=True,
        use_randaug=use_randaug, re_prob=re_prob, crop_scale=crop_scale,
        hflip=hflip, fused_model=fused_model, device=device)
    from .compress import sync_w_p
    keys = METRIC_KEYS_SEARCH if phase == "search" \
        else METRIC_KEYS_POSTSEARCH
    A = scfg.accum_iter
    micro = max(steps_per_epoch * A, 1)
    warm = scfg.schedule.warmup_epochs

    def step(state: TrainState, cache, idx_plan, labels_plan, generator,
             epoch_base, epoch):
        it = torch.div(state.step - epoch_base, A, rounding_mode="floor")
        frac = epoch.to(torch.float32) + (it * A).to(torch.float32) / micro
        sync_w_p(state.arch, frac, warm)
        keep = keep_ratio_schedule(frac, scfg, state.arch, space)
        imgs, lbls = _gather(cache, idx_plan, labels_plan, it, A)
        state, metrics = inner(state, imgs, lbls, generator, keep)
        return state, torch.stack([metrics[k].float() for k in keys])

    return PlannedStep(step, resolve_device(device)), keys


# ---------------------------------------------------------------------------
# Finetune / plain train step
# ---------------------------------------------------------------------------

def make_train_step(mcfg: ModelCfg, tx, *, num_classes: int, mixup_cfg=None,
                    smoothing: float = 0.1,
                    ema_decay: Optional[float] = None, teacher_apply=None,
                    distill=None, compute_dtype=torch.bfloat16,
                    fused_augment: bool = False, use_randaug: bool = True,
                    re_prob: float = 0.25, crop_scale=(0.08, 1.0),
                    hflip: bool = True, device="cuda"):
    """Plain supervised train step of the finetune stage, on `device`
    (default "cuda"; raises without a card unless device="cpu" is asked
    for).

    Returns step(state, images (A, mb, H, W, C), labels (A, mb),
    generator=None, mixup_draws=None, augment_draws=None) -> (state,
    {"loss": ...}); the state holds a dense `ViT` and no alphas. With
    `mixup_cfg` (mixup or cutmix above 0) the labels are soft;
    `mixup_draws` replaces the draws from `generator`. `fused_augment` and
    `augment_draws` as in `make_search_step`; with `teacher_apply` and a
    `distill` config whose type is not "none", the distillation loss (the
    class head's or a distilled model's second head's logits against the
    teacher's)."""
    dev = resolve_device(device)
    augment = _augmenter(fused_augment, mcfg.img_size, use_randaug, re_prob,
                         crop_scale, hflip)
    distill_on = teacher_apply is not None and distill is not None \
        and distill.distillation_type != "none"
    mix_on = mixup_cfg is not None and (mixup_cfg.mixup > 0
                                        or mixup_cfg.cutmix > 0)

    def loss_fn(params, images, labels, generator, draws):
        soft = False
        if mix_on:
            images, labels = _mixed(
                images, labels, generator, draws, mixup_cfg,
                num_classes=num_classes, mixup_alpha=mixup_cfg.mixup,
                cutmix_alpha=mixup_cfg.cutmix)
            soft = True
        out = vit_forward(params, images, mcfg, train=True,
                          generator=generator, compute_dtype=compute_dtype)
        # a distilled model's second head is the teacher's: only the class
        # head enters the base criterion, the other one the distillation
        logits, kd_logits = out if isinstance(out, tuple) else (out, out)
        base = L.base_criterion(logits, labels, soft_labels=soft,
                                smoothing=smoothing)
        if distill_on:
            base = L.distillation_loss(
                base, kd_logits, teacher_apply(images),
                kind=distill.distillation_type, alpha=distill.alpha,
                tau=distill.tau)
        return base, {"loss": base}

    def step(state: TrainState, images, labels, generator=None,
             mixup_draws=None, augment_draws=None):
        A = images.shape[0]
        images = augment(images, generator, augment_draws, dev) \
            if augment is not None else images.to(dev)
        labels = labels.to(dev)
        leaves = dict(state.params.named_parameters())

        def micro(a):
            return loss_fn(state.params, images[a], labels[a], generator,
                           mixup_draws[a] if mixup_draws is not None
                           else None)

        grads, metrics = _accumulate(leaves, A, micro)
        with torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 leaves)
            _apply(leaves, updates, state.ema_params, state.params,
                   ema_decay)
        state.step += A
        return state, metrics

    return step


def make_planned_train_step(mcfg: ModelCfg, tx, *, num_classes: int,
                            accum_iter: int = 1, mixup_cfg=None,
                            smoothing: float = 0.1,
                            ema_decay: Optional[float] = None,
                            teacher_apply=None, distill=None,
                            compute_dtype=torch.bfloat16,
                            use_randaug: bool = True, re_prob: float = 0.25,
                            crop_scale=(0.08, 1.0), hflip: bool = True,
                            device="cuda"):
    """The finetune step over the device cache, as
    `make_planned_search_step` does it for the search:

      step(state, cache, idx_plan, labels_plan, generator, epoch_base)
        -> (state, fp32 loss)

    the iteration's cache rows and labels gathered on the device, then the
    fused augment and `make_train_step`'s step. On the card a
    `PlannedStep`, replayed as a CUDA graph."""
    inner = make_train_step(
        mcfg, tx, num_classes=num_classes, mixup_cfg=mixup_cfg,
        smoothing=smoothing, ema_decay=ema_decay,
        teacher_apply=teacher_apply, distill=distill,
        compute_dtype=compute_dtype, fused_augment=True,
        use_randaug=use_randaug, re_prob=re_prob, crop_scale=crop_scale,
        hflip=hflip, device=device)
    A = accum_iter

    def step(state: TrainState, cache, idx_plan, labels_plan, generator,
             epoch_base):
        it = torch.div(state.step - epoch_base, A, rounding_mode="floor")
        imgs, lbls = _gather(cache, idx_plan, labels_plan, it, A)
        state, metrics = inner(state, imgs, lbls, generator)
        return state, metrics["loss"].float()

    return PlannedStep(step, resolve_device(device))


# ---------------------------------------------------------------------------
# Eval steps
# ---------------------------------------------------------------------------

def _cls_metrics(logits, labels) -> Dict[str, torch.Tensor]:
    """Sums over the batch, as fp32 tensors on the logits' device: the CE
    loss, top-1 and top-5 hits and the count."""
    n = labels.shape[0]
    loss = L.cross_entropy(logits, labels)
    top1 = (logits.argmax(dim=-1) == labels).sum()
    k = min(5, logits.shape[-1])
    top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1).sum()
    return {"loss_sum": loss * n, "top1": top1.float(), "top5": top5.float(),
            "count": torch.tensor(float(n), device=logits.device)}


def make_eval_step(space: SearchSpace, mcfg: ModelCfg, *,
                   compute_dtype=torch.bfloat16, fused: bool = False,
                   gate_fold: bool = True, device="cuda"):
    """Search-model eval: step(params, alphas, arch, images, labels) ->
    `_cls_metrics` sums. fused=True evaluates a post-fuse supernet (scores
    folded into the weights, gates off)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, alphas, arch, images, labels):
        out = mim_forward(params, alphas, arch, images.to(dev), mcfg, space,
                          train=False, use_mim=False, fused=fused,
                          gate_fold=gate_fold, compute_dtype=compute_dtype)
        return _cls_metrics(out.logits, labels.to(dev))

    return step


def make_eval_step_dense(mcfg: ModelCfg, *, compute_dtype=torch.bfloat16,
                         device="cuda"):
    """Dense-model eval: step(params, images, labels) -> `_cls_metrics`
    sums."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, images, labels):
        logits = vit_forward(params, images.to(dev), mcfg, train=False,
                             compute_dtype=compute_dtype)
        return _cls_metrics(logits, labels.to(dev))

    return step
