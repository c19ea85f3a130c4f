"""Rank bodies for the port's multi-process tests, run by
``_torch_ranks.run_ranks`` in its ``spawn`` processes (numpy and the port
only: no JAX in the children). A rank process runs many bodies in turn,
so a body leaves no setting of its own behind."""
import os
import shutil

import numpy as np

THREADS = 2  # per rank: the ranks share the test worker's cores


def _threads():
    import torch

    torch.set_num_threads(THREADS)


def tile_shard(rank, world, model_dir, input_dir, output_dir, batch_size):
    """``tests/_distributed_worker.py`` on the port: this rank's strided
    share of the tiles (``shard_slides``) through the tile manager on the
    CPU. Returns the share."""
    _threads()
    import yaml

    from cerberus_tpu_torch.infer.tile import InferManager
    from cerberus_tpu_torch.parallel.distributed import (
        process_info,
        shard_slides,
    )

    assert process_info() == (rank, world), process_info()
    names = sorted(os.listdir(input_dir))
    mine, _ = shard_slides(names, [None] * len(names))
    my_in = os.path.join(output_dir, "_in_p%d" % rank)
    os.makedirs(my_in, exist_ok=True)
    for name in mine:
        shutil.copy(os.path.join(input_dir, name), os.path.join(my_in, name))
    with open(os.path.join(model_dir, "settings.yml")) as handle:
        settings = yaml.safe_load(handle)
    infer = InferManager(
        checkpoint_path=os.path.join(model_dir, "weights.tar"),
        decoder_dict=settings["dataset_kwargs"]["req_target_code"],
        model_args=settings["model_kwargs"], device="cpu")
    infer.process_file_list(tile_run_args(my_in, output_dir, batch_size))
    return mine


def tile_run_args(input_dir, output_dir, batch_size):
    return {"nr_inference_workers": 0, "nr_post_proc_workers": 0,
            "batch_size": batch_size, "input_dir": str(input_dir),
            "output_dir": str(output_dir), "patch_input_shape": 144,
            "patch_output_shape": 48, "patch_output_overlap": 0,
            "postproc_list": ["gland", "lumen", "nuclei", "patch-class"]}


def stub_step(_self, batch, out_sz):
    """A deterministic numpy forward: each window's centre crop -> INST
    probabilities from its colour channels, TYPE and Patch-Class ids."""
    import torch

    batch = batch.cpu().numpy()
    m = (batch.shape[1] - out_sz) // 2
    crop = batch[:, m:m + out_sz, m:m + out_sz].astype(np.float32) / 255.0
    inst = []
    for ch, centre in ((1, 0.5), (0, 0.4), (2, 0.55)):
        fg = 1.0 / (1.0 + np.exp(-12 * (crop[..., ch] - centre)))
        inst += [fg * 0.9, (1 - fg) * 0.05]
    ids = np.minimum(np.floor(crop[..., 2] * 7), 6)
    out = np.stack(inst + [ids, np.minimum(np.floor(crop[..., 0] * 3), 2),
                           np.zeros_like(ids)], -1)
    return torch.from_numpy(out.astype(np.float32))


def wsi_shard(rank, world, slides, root, model_kwargs, target_code):
    """``process_wsi_list`` of the WSI manager (stub forward, ``gpu``
    backend on the CPU) over every slide: this rank processes its strided
    share with a ``_host<rank>`` cache. Returns (its slides, the cache
    path it used)."""
    _threads()
    from cerberus_tpu_torch.infer import wsi as port_wsi

    infer = port_wsi.InferManager(decoder_dict=dict(target_code),
                                  model_args=model_kwargs, device="cpu")
    infer.run_step = stub_step.__get__(infer)
    infer.process_wsi_list({
        "nr_inference_workers": 0, "nr_post_proc_workers": 0,
        "batch_size": 8, "input_list": list(slides),
        "mask_list": [None] * len(slides),
        "output_dir": os.path.join(root, "out"), "patch_input_shape": 144,
        "patch_output_shape": 48, "save_thumb": False, "save_mask": False,
        "postproc_list": ["gland", "lumen", "nuclei", "patch-class"],
        "tile_shape": 192, "chunk_shape": 480, "ambiguous_size": 16,
        "cache_path": os.path.join(root, "cache"),
        "logging_dir": os.path.join(root, "logging_%d" % rank),
        "wsi_proc_mag": 0.5, "postproc_backend": "gpu"})
    return [os.path.basename(s) for s in infer.input_list], infer.cache_path


def dp_train_step(rank, world, kwargs, state, batch, keep, dtype_name,
                  grad_accum, loss_kwargs, opt_kwargs, extra_batches=(),
                  remat=False, paired=False):
    """One data-parallel step (``make_sharded_train_step`` on a CPU
    process mesh; width-paired with ``paired``) from ``state`` on the
    GLOBAL ``batch``: (metrics,
    gradients, state dict after, Adam state as numpy). Each of
    ``extra_batches`` must then raise ``ValueError`` (returned as its
    message)."""
    _threads()
    import torch

    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc
    from cerberus_tpu_torch.parallel.mesh import (
        make_mesh,
        make_sharded_train_step,
    )

    dtype = getattr(torch, dtype_name)
    cfg = ModelConfig.from_kwargs(kwargs)
    model = NetDesc(cfg)
    model.load_state_dict(state)
    model.to(dtype)
    mesh = make_mesh([torch.device("cpu")] * world, group="world")
    step = make_sharded_train_step(cfg, mesh, loss_kwargs, opt_kwargs,
                                   grad_accum=grad_accum, remat=remat,
                                   return_grads=True, model=model,
                                   paired=paired)
    metrics, grads = step(batch, keep=keep)
    errors = []
    for bad in extra_batches:
        try:
            step(bad, keep=None)
        except ValueError as exc:
            errors.append(str(exc))
    opt = {step.param_names[i]: {k: v.numpy().copy() for k, v in st.items()
                                 if torch.is_tensor(v) and v.dim() > 0}
           for i, st in step.optimizer.state_dict()["state"].items()}
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy().copy() for k, v in grads.items()},
            {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()},
            opt, errors)


def dp_jax_layout_steps(rank, world, kwargs, param_sets, batch, keep,
                        loss_kwargs, opt_kwargs):
    """The f32 data-parallel step from each JAX-layout parameter tree of
    ``param_sets`` (fresh Adam state, update count 0) on the GLOBAL
    ``batch``: per set (metrics, gradients in the JAX layout, the JAX-layout
    train state after)."""
    _threads()
    import torch

    from cerberus_tpu_torch.config import ModelConfig
    from cerberus_tpu_torch.models import convert
    from cerberus_tpu_torch.models.net_desc import NetDesc
    from cerberus_tpu_torch.parallel.mesh import (
        make_mesh,
        make_sharded_train_step,
    )

    cfg = ModelConfig.from_kwargs(kwargs)
    mesh = make_mesh([torch.device("cpu")] * world, group="world")
    out = []
    for params in param_sets:
        step = make_sharded_train_step(cfg, mesh, loss_kwargs, opt_kwargs,
                                       return_grads=True,
                                       model=NetDesc(cfg))
        step.load_jax_train_state(params, None, 0)
        metrics, grads = step(batch, keep=keep)
        out.append(({k: float(v) for k, v in metrics.items()},
                    convert.jax_params_from_state_dict(
                        {k: v for k, v in grads.items()}),
                    step.jax_train_state()))
    return out


def load_with_fake_nvcc(rank, world, build_dir, cuda_home):
    """``cuda_build.load("cc_label")`` with the build directory at
    ``build_dir``, the ``nvcc`` of ``cuda_home`` (a stand-in that writes
    its output file) and ``ctypes.CDLL`` recording the path it opens.
    Returns that path."""
    import ctypes

    from cerberus_tpu_torch.ops import cuda_build

    saved = (os.environ.get("CUDA_HOME"), cuda_build.BUILD_DIR,
             dict(cuda_build._libs))
    os.environ["CUDA_HOME"] = cuda_home
    cuda_build.BUILD_DIR = build_dir
    cuda_build.ctypes.CDLL = lambda path: path
    try:
        return cuda_build.load("cc_label")
    finally:
        cuda_build.ctypes.CDLL = ctypes.CDLL
        cuda_build.BUILD_DIR = saved[1]
        cuda_build._libs.clear()
        cuda_build._libs.update(saved[2])
        if saved[0] is None:
            os.environ.pop("CUDA_HOME", None)
        else:
            os.environ["CUDA_HOME"] = saved[0]


def dp_build_trainer(rank, world, log_dir, batch):
    """``train.opt.build_trainer(mesh=...)`` on a CPU process mesh, then one
    call of its train step on the GLOBAL ``batch``: (the step's group
    size, the log directory this rank's engine writes to, the metrics)."""
    _threads()
    import torch

    from _torch_train_helpers import LOSS_KWARGS, MODEL_KWARGS
    from cerberus_tpu_torch.parallel.mesh import make_mesh
    from cerberus_tpu_torch.train import opt

    mesh = make_mesh([torch.device("cpu")] * world, group="world")
    config = opt.get_config(MODEL_KWARGS, LOSS_KWARGS)
    train_engine, _, net = opt.build_trainer(config, {}, {}, log_dir,
                                             mesh=mesh)
    metrics = net.train_step(batch, generator=net.generator)
    return (net.train_step.world, getattr(train_engine.state, "log_dir",
                                          None),
            {k: float(v) for k, v in metrics.items()})
