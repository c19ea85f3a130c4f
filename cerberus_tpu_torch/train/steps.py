"""Training and validation steps for the multi-task model.

Counterpart of ``cerberus_tpu/train/steps.py:48-400`` (reference
``models/run_desc.py:25-230,332-436``):
  * batch = {img NHWC uint8, per-head GT maps (N, h, w, 1), per-head weight
    maps ``<head>#WEIGHT-MAP``, ``has_target`` (N, n_heads) in
    ``head_order``}: the host batches of ``data/train_loader.py``;
  * per-head loss = sum over {ce, dice} with per-head weights, class
    weight maps for TYPE heads, and dummy masking by ``has_target``; dice
    on the softmax foreground classes, masked to labelled pixels,
    batch-joint; the Patch-Class CE masked like every other head;
  * Adam (AdamW when ``weight_decay`` is set: optax's ``adamw`` decouples
    the decay) with StepLR evaluated at the count of updates already
    taken.

The step keeps the JAX semantics where torch's defaults differ:
  * every trainable parameter has a gradient tensor from the start and the
    step zeroes it in place, so a head without targets gets a zero
    gradient, not ``None``: Adam still decays its moments and AdamW its
    weights, as optax does;
  * subtype-frozen parameters get no gradient and are not in the
    optimizer (no update, no decay); their BN layers run in eval mode
    (``NetDesc.train``);
  * ``grad_accum=K`` runs K microbatches in order, sums their gradients,
    divides by K and takes one optimizer step; each microbatch folds its BN
    statistics as it runs (the closed form of JAX
    ``_apply_bn_updates_stacked``);
  * bf16 is ``torch.autocast`` over the forward: parameters, Adam moments
    and BN statistics stay f32, and the logits are cast to f32 before the
    loss (JAX casts at ``steps.py:187``).

With a process ``group`` (``parallel/mesh.make_sharded_train_step``) the
step is data-parallel and still the single-device step on the global
batch, as the JAX package's sharded step is: each rank takes its rows of
every microbatch, BN statistics (``layers.sync_batch_stats``), the dice
sums and the per-head flag sums are all-reduced in the forward, each rank
backpropagates its copy of the global loss divided by the world size (the
all-reduces' backward sums the ranks' gradients), and the gradients are
all-reduced once, as one flat buffer, before the identical update.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models import convert
from ..models.layers import allsum, dropout_mask, sync_batch_stats
from ..models.net_desc import (
    REMAT_MODES,
    NetDesc,
    head_output_channels,
    subtype_frozen_prefixes,
)
from ..utils.debug import check_finite, debug_mode_requested
from .losses import class_weight_map, dice_loss, xentropy_loss


def head_order(cfg: ModelConfig) -> List[str]:
    return list(head_output_channels(cfg).keys())


def make_lr_schedule(base_lr: float = 1.0e-3, decay_steps: int = 75000,
                     gamma: float = 0.1):
    """StepLR: ``lr(count) = base_lr * gamma ** (count // decay_steps)``,
    ``count`` the updates already taken (0 at the first step)."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** (int(count) // decay_steps)

    return schedule


def make_optimizer(params, optimizer_kwargs: Optional[Mapping] = None,
                   schedule=None):
    """(optimizer, schedule) over ``params`` from the settings'
    ``optimizer_kwargs`` (lr, betas, weight_decay, lr_decay_steps)."""
    kwargs = dict(optimizer_kwargs or {})
    lr = float(kwargs.get("lr", 1.0e-3))
    betas = tuple(float(b) for b in kwargs.get("betas", (0.9, 0.999)))
    wd = float(kwargs.get("weight_decay", 0.0))
    if schedule is None:
        schedule = make_lr_schedule(lr, int(kwargs.get("lr_decay_steps",
                                                       75000)))
    cls = torch.optim.AdamW if wd else torch.optim.Adam
    return cls(params, lr=schedule(0), betas=betas, eps=1e-8,
               weight_decay=wd), schedule


def loss_weight_tables(loss_kwargs: Optional[Mapping], cfg: ModelConfig):
    """Static {head: (head weight, {loss name: weight}, class weights)}."""
    loss_info = (loss_kwargs or {}).get("loss_info", {})
    class_weight = (loss_kwargs or {}).get("class_weight", {}) or {}
    tables = {}
    for head in head_order(cfg):
        info = loss_info.get(head, {"weight": 1.0, "loss": {"ce": 1}})
        tables[head] = (
            float(info.get("weight", 1.0)),
            {k: float(v) for k, v in info.get("loss", {"ce": 1}).items()},
            {int(k): float(v)
             for k, v in (class_weight.get(head) or {}).items()},
        )
    return tables


def head_losses(pred: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, loss_tables, group=None
                ) -> Tuple[torch.Tensor, Dict]:
    """(total, {"<head>_loss", "overall_loss"}) from NCHW logits and a
    device batch (the loss half of JAX ``multitask_loss``). The loss runs
    in f32, or in f64 for f64 logits. ``group``: the batch is this rank's
    rows, and every batch-joint sum spans the ranks (``layers.allsum``)."""
    n_ch = head_output_channels(cfg)
    dtype = torch.promote_types(next(iter(pred.values())).dtype,
                                torch.float32)
    has_target = batch["has_target"].to(dtype)
    total = torch.zeros((), dtype=dtype, device=has_target.device)
    metrics = {}
    for h_idx, head in enumerate(head_order(cfg)):
        if head not in batch:
            continue
        head_weight, loss_dict, cls_weights = loss_tables[head]
        logits = pred[head].to(dtype)
        true = batch[head]
        flag = has_target[:, h_idx]
        if head == "Patch-Class":
            ce = xentropy_loss(true.reshape(true.shape[0]).long(),
                               logits.reshape(logits.shape[0], -1))
            term = _flagged_mean(ce, flag, group)
            head_loss = loss_dict.get("ce", 0.0) * term
        else:
            label = true[..., 0].long()  # (N, h, w)
            if head.endswith("-TYPE"):
                wmap = class_weight_map(label, cls_weights, n_ch[head])
            elif head + "#WEIGHT-MAP" in batch:
                wmap = batch[head + "#WEIGHT-MAP"][..., 0]
            else:
                wmap = torch.ones(label.shape, device=label.device)
            wmap = wmap.to(dtype)
            head_loss = torch.zeros_like(total)
            for loss_name, loss_weight in loss_dict.items():
                if loss_name == "dice":
                    onehot = F.one_hot(label, n_ch[head]).permute(
                        0, 3, 1, 2).to(dtype)
                    prob = torch.softmax(logits, dim=1)
                    mask = (label > 0).to(dtype)[:, None]
                    term = dice_loss(onehot[:, 1:], prob[:, 1:], mask=mask,
                                     group=group)
                else:
                    pix = xentropy_loss(label, logits) * wmap
                    per_sample = torch.mean(pix, dim=(1, 2))
                    term = _flagged_mean(per_sample, flag, group)
                head_loss = head_loss + loss_weight * term
        metrics["%s_loss" % head] = head_loss * head_weight
        total = total + head_loss * head_weight
    metrics["overall_loss"] = total
    return total, metrics


def _flagged_mean(per_sample: torch.Tensor, flag: torch.Tensor, group=None
                  ) -> torch.Tensor:
    """sum(per_sample * flag) / (sum(flag) + 1e-8) over the batch (over
    every rank's rows with ``group``)."""
    sums = allsum(torch.stack([torch.sum(per_sample * flag),
                               torch.sum(flag)]), group)
    return sums[0] / (sums[1] + 1.0e-8)


def images_to_input(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """NHWC uint8 -> NCHW in [0, 1] (JAX ``imgs / 255``)."""
    return img.permute(0, 3, 1, 2).to(dtype) / 255.0


def autocast(device: torch.device, compute_dtype):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)


def multitask_loss(model: NetDesc, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, loss_tables, keep=None,
                   compute_dtype=torch.float32, remat=False, group=None,
                   paired: bool = False):
    """The training forward (``NetDesc.forward_train``, every active head;
    width-paired with ``paired``) and ``head_losses`` on a device batch ->
    (total, metrics). The input takes the parameters' dtype (f32; f64 for
    a model in f64). ``group``: the loss sums span its ranks (the
    forward's BN syncs under ``layers.sync_batch_stats``, which the caller
    holds)."""
    x = images_to_input(batch["img"], next(model.parameters()).dtype)
    with autocast(x.device, compute_dtype):
        pred = model.forward_train(x, remat=remat, keep=keep, paired=paired)
    return head_losses(pred, batch, cfg, loss_tables, group)


def batch_to_device(batch: Mapping, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Host (numpy) batch -> tensors on ``device``: on the card through
    pinned memory with non-blocking copies."""
    out = {}
    for key, value in batch.items():
        tensor = torch.as_tensor(np.asarray(value))
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        else:
            tensor = tensor.to(device)
        out[key] = tensor
    return out


class TrainStep:
    """``step(batch, keep=None, generator=None) -> metrics`` (and the
    gradients with ``return_grads``): forward over every head, the masked
    multi-task loss, backward, one optimizer update and the BN folds, on
    ``model``'s device. ``step.count`` is the number of updates taken.

    ``keep``: the Patch-Class dropout keep-mask of the whole batch,
    (N, C, 1, 1) bool, sliced per microbatch; else the masks are drawn from
    ``generator``; with neither there is no dropout. With
    ``CERBERUS_DEBUG`` set, every loss scalar is checked for NaN/Inf
    (``FloatingPointError`` naming it).

    ``paired``: the width-paired training forward
    (``NetDesc.forward_train``; JAX ``make_train_step(paired=True)``).

    ``group`` (a ``torch.distributed`` process group; the model on this
    rank's device): the data-parallel step. Each call takes the GLOBAL
    batch (and ``keep``) and must be made on every rank with the same
    batch; a batch that does not divide by ``grad_accum`` x the world
    size raises ``ValueError``. The weights are broadcast from the
    group's first rank here, so every rank starts from the same state."""

    def __init__(self, model: NetDesc, cfg: ModelConfig, loss_kwargs=None,
                 optimizer_kwargs=None, compute_dtype=torch.float32,
                 remat=False, grad_accum: int = 1,
                 return_grads: bool = False, group=None,
                 paired: bool = False):
        if grad_accum < 1:
            raise ValueError("grad_accum must be >= 1, got %d" % grad_accum)
        if remat not in REMAT_MODES:
            raise ValueError("remat must be bool or 'backbone'/'towers', "
                             "got %r" % (remat,))
        self.model = model
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.paired = paired
        self.grad_accum = grad_accum
        self.return_grads = return_grads
        self.loss_tables = loss_weight_tables(loss_kwargs, cfg)
        frozen = subtype_frozen_prefixes(cfg)
        self.named_params = []
        for name, param in model.named_parameters():
            param.requires_grad_(frozen is None or not frozen(name))
            if param.requires_grad:
                param.grad = torch.zeros_like(param)
                self.named_params.append((name, param))
        self.optimizer, self.schedule = make_optimizer(
            [p for _, p in self.named_params], optimizer_kwargs)
        self.weight_decay = bool(
            float((optimizer_kwargs or {}).get("weight_decay", 0.0)))
        self.debug = debug_mode_requested()
        self.count = 0
        self.group = group
        self.rank, self.world = 0, 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            src = dist.get_process_group_ranks(group)[0]
            with torch.no_grad():
                for tensor in list(model.parameters()) + list(model.buffers()):
                    dist.broadcast(tensor.data, src=src, group=group)

    @property
    def param_names(self) -> List[str]:
        return [name for name, _ in self.named_params]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def __call__(self, batch: Mapping, keep: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        model, k, world = self.model, self.grad_accum, self.world
        model.train()  # also puts subtype-frozen BN layers in eval mode
        n = len(batch["img"])
        if n % (k * world):
            raise ValueError("batch size %d not divisible by grad_accum x "
                             "ranks (%d x %d)" % (n, k, world))
        self.optimizer.zero_grad(set_to_none=False)
        m = n // k
        rows = m // world  # this rank's rows of each microbatch
        # one copy of this rank's rows of every microbatch (the whole batch
        # on one device), sliced per microbatch on the device
        if world > 1:
            index = (np.arange(k)[:, None] * m + self.rank * rows
                     + np.arange(rows)[None, :]).reshape(-1)
            batch = {key: np.asarray(v)[index] for key, v in batch.items()}
            if keep is not None:
                keep = keep[torch.as_tensor(index, device=keep.device)]
        batch = batch_to_device(batch, self.device)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
            lo = i * rows
            micro = {key: v[lo:lo + rows] for key, v in batch.items()}
            micro_keep = (None if keep is None
                          else keep[lo:lo + rows].to(self.device))
            if micro_keep is None and generator is not None \
                    and "Patch-Class" in model.decoder_head:
                # the whole microbatch's mask (every rank's generator is
                # alike), as the forward would draw it on one device
                micro_keep = dropout_mask(
                    (m, self._pclass_channels(), 1, 1), generator,
                    self.device)[self.rank * rows:(self.rank + 1) * rows]
            with sync_batch_stats(model, self.group):
                total, metrics = multitask_loss(
                    model, micro, self.cfg, self.loss_tables,
                    keep=micro_keep, compute_dtype=self.compute_dtype,
                    remat=self.remat, group=self.group, paired=self.paired)
                (total / world).backward()
            for key, value in metrics.items():
                value = value.detach()
                if self.debug:
                    check_finite(key, value)
                sums[key] = sums[key] + value if key in sums else value
        if world > 1:
            self._all_reduce_grads()
        if k > 1:
            for _, param in self.named_params:
                param.grad.div_(k)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1
        metrics = {key: value / k for key, value in sums.items()}
        if self.return_grads:
            return metrics, {name: p.grad.detach().clone()
                             for name, p in self.named_params}
        return metrics

    def _pclass_channels(self) -> int:
        return self.model.decoder_head["Patch-Class"].bn1.num_features

    def _all_reduce_grads(self) -> None:
        """Sum the ranks' gradients: one all-reduce of one flat buffer."""
        import torch.distributed as dist

        grads = [p.grad for _, p in self.named_params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    # -- train state in the JAX package's layout --------------------------
    def jax_train_state(self):
        """(params, opt_state, step) as numpy trees in the JAX layout
        (``models/convert.train_state_to_jax``): a host snapshot."""
        return convert.train_state_to_jax(
            self.model.state_dict(), self.optimizer.state_dict(),
            self.param_names, self.weight_decay, self.count)

    def load_jax_train_state(self, params, opt_state, step: int) -> None:
        """Restore a JAX-layout train state (``opt_state`` may be None:
        fresh moments)."""
        state_dict, opt_sd = convert.train_state_from_jax(
            params, opt_state, self.param_names)
        self.model.load_state_dict(state_dict, strict=True)
        if opt_state:
            groups = self.optimizer.state_dict()["param_groups"]
            opt_sd["param_groups"] = [
                dict(group, params=saved["params"])
                for group, saved in zip(groups, opt_sd["param_groups"])]
            self.optimizer.load_state_dict(opt_sd)
        self.count = int(step)


def make_train_step(cfg: ModelConfig, loss_kwargs=None, optimizer_kwargs=None,
                    compute_dtype=torch.float32, remat=False,
                    grad_accum: int = 1, return_grads: bool = False, *,
                    model: NetDesc, paired: bool = False) -> TrainStep:
    """A ``TrainStep`` on ``model`` (JAX ``make_train_step``; the model,
    its optimizer and the update count live in the step object)."""
    return TrainStep(model, cfg, loss_kwargs, optimizer_kwargs,
                     compute_dtype, remat, grad_accum, return_grads,
                     paired=paired)


def make_valid_step(model: NetDesc, compute_dtype=torch.float32):
    """Eval forward + activations (reference valid_step,
    models/run_desc.py:332-436): INST -> softmax foreground channels, TYPE
    -> softmax (both NHWC), Patch-Class -> argmax. Takes NHWC uint8
    images (host or device) -> {head: tensor}."""

    @torch.no_grad()
    def step(imgs) -> Dict[str, torch.Tensor]:
        model.eval()
        device = next(model.parameters()).device
        x = images_to_input(batch_to_device({"img": imgs}, device)["img"])
        with autocast(device, compute_dtype):
            pred = model(x)
        out = {}
        for head, logits in pred.items():
            logits = logits.float()
            if head == "Patch-Class":
                out[head] = logits.reshape(logits.shape[0], -1).argmax(-1)
            elif head.endswith("-INST"):
                out[head] = torch.softmax(logits, 1)[:, 1:].permute(
                    0, 2, 3, 1)
            else:
                out[head] = torch.softmax(logits, 1).permute(0, 2, 3, 1)
        return out

    return step
