"""run_train.py (PyTorch + CUDA port) — multi-task training launcher.

Usage:
  run_train.py [--gpu=<id>] [--settings=<path>] [--log_dir=<path>] \
               [--nr_epochs=<n>] [--batch_size=<n>] [--seed=<n>] \
               [--pretrained=<path>] [--pretrained_fold=<n>] \
               [--pretrained_tag=<str>] [--per_n_steps=<n>] \
               [--resume=<path>] [--bf16] [--remat=<stage>] \
               [--grad_accum=<k>] [--paired]
  run_train.py (-h | --help)

Options:
  -h --help            Show this string.
  --gpu=<id>           GPU to train on (cuda:<id>). One GPU only: data-parallel training is build_trainer(mesh=...) in one process per card. [default: 0]
  --settings=<path>    Path to a settings.yml/paramset.yml (loader/optimizer/loss/dataset/model kwargs).
  --log_dir=<path>     Checkpoint + stats output directory. [default: logs/]
  --nr_epochs=<n>      Number of epochs. [default: 140]
  --batch_size=<n>     Batch size override. [default: 12]
  --seed=<n>           RNG seed. [default: 0]
  --pretrained=<path>  Checkpoint to initialize from: torch tar / native msgpack /
                       raw torchvision ImageNet state_dict (backbone-only; decoders
                       keep fresh init) / a pretrained.yml-style map (backbone ->
                       foldN -> tag -> path, the reference models/pretrained.yml
                       schema) resolved with --pretrained_fold/--pretrained_tag.
  --pretrained_fold=<n>  Fold entry when --pretrained is a yml map. [default: 1]
  --pretrained_tag=<str> Tag entry when --pretrained is a yml map. [default: imagenet_mtl]
  --per_n_steps=<n>    Logging/checkpoint/validation cadence in steps. [default: 2000]
  --resume=<path>      Resume a full training checkpoint (params + optimizer + step).
  --bf16               Mixed precision: torch.autocast to bfloat16 over the forward;
                       params, optimizer moments, BN stats and loss reductions
                       stay float32 (no reference analog).
  --remat=<stage>      Activation checkpointing (torch.utils.checkpoint): "all"
                       checkpoints the encoder and every tower with its heads,
                       "backbone"/"towers" only that stage class. [default: off]
  --grad_accum=<k>     Gradient accumulation: split each batch into <k>
                       sequential microbatches (grads averaged, one Adam
                       update, BN stats folded per microbatch in order).
                       batch_size must be divisible by <k>. [default: 1]
  --paired             Width-paired encoder front AND decoder-tower finest
                       levels in the training forward+backward
                       (models/paired_encoder.py, models/paired_tower.py), the
                       JAX package's TPU lowering of the 64-channel stages.
                       Divergence is conv-accumulation reassociation only.
                       Requires a basic-block resnet backbone and input
                       width % 4 == 0. Default keeps the unpaired path.

Run as ``python -m cerberus_tpu_torch.run_train``. The flags are those of
the JAX package's ``run_train.py``. ``CERBERUS_DEFAULT_DEVICE=cpu`` trains
without a card. Checkpoints (``<log_dir>/net_step-NNNNNN.tar``) are the JAX
package's train states (native msgpack): the port's tile and WSI CLIs
serve them, and the JAX package resumes them. The dataset comes from the
settings' ``dataset_kwargs``: ``train_dir`` (+ optional ``valid_dir``) for
the built-in ``MTLPatchDataset``, or ``loader_module`` exposing
``make_loaders(paramset, batch_size)``.
"""
from __future__ import annotations

import importlib

from .config import ParamSet
from .utils import mkdir
from .utils.cli import docopt
from .utils.debug import configure_from_env, default_device
from .utils.profiling import maybe_profile

REMAT_ARGS = {"off": False, "0": False, "false": False, "all": True,
              "true": True, "1": True, "backbone": "backbone",
              "towers": "towers"}


def make_loaders(paramset: ParamSet, batch_size: int):
    """(train_loaders, valid_loaders) from the settings' dataset_kwargs."""
    dk = paramset.dataset_kwargs
    if dk.get("loader_module"):
        mod = importlib.import_module(dk["loader_module"])
        return mod.make_loaders(paramset, batch_size)
    if not dk.get("train_dir"):
        raise SystemExit(
            "settings.yml dataset_kwargs must declare either train_dir "
            "(+ optional valid_dir) for the built-in MTLPatchDataset, or "
            "loader_module exposing make_loaders(paramset, batch_size)")
    from .data.train_loader import MTLPatchDataset

    cfg = paramset.model_config
    common = dict(req_target_code=paramset.req_target_code,
                  input_shape=int(dk.get("input_shape", 448)),
                  output_shape=int(dk.get("output_shape", 448)),
                  batch_size=batch_size)
    train = {"train": MTLPatchDataset.from_dir(dk["train_dir"], cfg,
                                               **common)}
    # drop_last=False: validation sees every sample, also a set smaller
    # than the batch
    valid = {"valid": MTLPatchDataset.from_dir(
        dk.get("valid_dir", dk["train_dir"]), cfg, augment=False,
        shuffle=False, drop_last=False, **common)}
    return train, valid


def main(argv=None, device=None):
    """Parse ``argv`` and train; returns the last phase's ``NetHolder``.
    ``device`` overrides ``--gpu`` (the tests pass ``device="cpu"``), as
    ``CERBERUS_DEFAULT_DEVICE`` does when ``device`` is None."""
    configure_from_env()
    args = docopt(__doc__, argv=argv)
    gpus = str(args["--gpu"]).split(",")
    if len(gpus) > 1:
        raise NotImplementedError(
            "--gpu=%s: run_train trains on one card, as the JAX CLI does. "
            "Data-parallel training (ROADMAP queue 1 item 7) runs one "
            "process per card: call parallel.distributed.initialize, then "
            "train.opt.build_trainer(mesh=parallel.mesh.make_mesh("
            "group='world'))" % args["--gpu"])
    if device is None:
        device = default_device() or "cuda:%d" % int(gpus[0])
    remat_arg = (args["--remat"] or "off").lower()
    if remat_arg not in REMAT_ARGS:
        raise SystemExit("--remat must be off/all/backbone/towers, got %r"
                         % remat_arg)
    batch_size = int(args["--batch_size"])
    grad_accum = int(args["--grad_accum"])
    if grad_accum < 1 or batch_size % grad_accum:
        raise SystemExit("--batch_size=%d must be a positive multiple of "
                         "--grad_accum=%d" % (batch_size, grad_accum))

    paramset = ParamSet.from_yaml(args["--settings"])
    from .train.opt import get_config, run_training

    log_dir = args["--log_dir"]
    mkdir(log_dir)
    config = get_config(paramset.model_kwargs, paramset.loss_kwargs,
                        paramset.optimizer_kwargs,
                        nr_epochs=int(args["--nr_epochs"]),
                        per_n_steps=int(args["--per_n_steps"]))
    if args["--resume"]:
        config["phase_list"][0]["run_info"]["net"]["resume_from"] = \
            args["--resume"]

    pretrained_params = None
    if args["--pretrained"]:
        from .models.convert import load_checkpoint, resolve_pretrained_map

        path = args["--pretrained"]
        if path.endswith((".yml", ".yaml")):
            path = resolve_pretrained_map(
                path, paramset.model_kwargs["encoder_backbone_name"],
                args["--pretrained_fold"], args["--pretrained_tag"])
        pretrained_params = load_checkpoint(path)

    train_loaders, valid_loaders = make_loaders(paramset, batch_size)
    import torch

    with maybe_profile("run_train"):
        return run_training(
            config, train_loaders, valid_loaders, log_dir=log_dir,
            seed=int(args["--seed"]), pretrained_params=pretrained_params,
            compute_dtype=torch.bfloat16 if args["--bf16"] else None,
            remat=REMAT_ARGS[remat_arg], grad_accum=grad_accum,
            paired=bool(args["--paired"]), device=device)


if __name__ == "__main__":
    main()
