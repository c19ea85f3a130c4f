"""run_infer_tile.py (PyTorch + CUDA port)

Usage:
  run_infer_tile.py [--gpu=<id>] [--model=<path>] [--nr_inference_workers=<n>] \
            [--nr_post_proc_workers=<n>] [--batch_size=<n>] [--input_dir=<path>] \
            [--output_dir=<path>] [--patch_input_shape=<n>] [--patch_output_shape=<n>] \
            [--postproc_backend=<str>] [--tile_backend=<str>] [--dense]
  run_infer_tile.py (-h | --help)
  run_infer_tile.py --version

Options:
  -h --help                   Show this string.
  --version                   Show version.
  --gpu=<id>                  GPU to run on (cuda:<id>), or a comma list of GPUs: each batch is split over them (a mesh). [default: 0]
  --model=<path>              Path to the model directory (weights.tar + settings.yml).
  --nr_inference_workers=<n>  Number of workers during inference. [default: 0]
  --nr_post_proc_workers=<n>  Number of workers during post-processing. [default: 0]
  --batch_size=<n>            Batch size. [default: 10]
  --input_dir=<path>          Path to input data directory. Assumes the files are not nested within directory.
  --output_dir=<path>         Path to output data directory. Will create automtically if doesn't exist. [default: output/]
  --patch_input_shape=<n>     Shape of input patch to the network- Assume square shape. [default: 448]
  --patch_output_shape=<n>    Shape of network output- Assume square shape. [default: 144]
  --dense                     Dense inference: 1168->864 windows (~3x fewer FLOPs per output px at the same 152 px margin). Overrides the patch shape flags; use --batch_size=16 or less (windows are 6.8x larger)
  --postproc_backend=<str>    Instance post-processing backend: gpu (the CUDA families on the card; tpu is an alias) or cpu (the scipy/cv2 families on the host). The default deliberately differs from the JAX CLI's cpu: --postproc_backend=cpu reproduces the reference's run. [default: gpu]
  --tile_backend=<str>        Tile engine: host (windows of several files batched together, a stitch per file) or fused (each file's batches written into one device canvas as they come out; needs overlap 0). [default: host]

Run as ``python -m cerberus_tpu_torch.run_infer_tile``. The flags are those
of the JAX package's ``run_infer_tile.py``. ``--postproc_backend=cpu``
(the JAX CLI's default, the reference's run) copies each stitched canvas to
the host and runs the scipy/cv2 families there, in a pool of
``--nr_post_proc_workers`` processes (0: in this process).
``--nr_inference_workers`` is accepted for compatibility.
``CERBERUS_DEFAULT_DEVICE=cpu`` runs it without a card. The model
directory's ``weights.tar`` may be a torch checkpoint or the JAX package's
native msgpack one.
"""
from __future__ import annotations

import os

from .config import DEFAULT_TARGET_LIST, load_settings
from .utils import rm_n_mkdir
from .utils.cli import docopt
from .utils.debug import configure_from_env, default_device


def main(argv=None, device=None) -> None:
    """Parse ``argv`` and run tile inference. ``device`` overrides
    ``--gpu`` (the tests pass ``device="cpu"``), as
    ``CERBERUS_DEFAULT_DEVICE`` does when ``device`` is None."""
    configure_from_env()
    args = docopt(__doc__, argv=argv,
                  version="CoBi Gland Inference (cerberus-tpu-torch)")
    if device is None:
        device = default_device()
    mesh = None
    if device is None:
        from .parallel.mesh import gpu_flag_devices

        device, mesh = gpu_flag_devices(args["--gpu"])

    output_dir = args["--output_dir"]
    if not os.path.exists(output_dir):
        rm_n_mkdir(output_dir)
    model_dir = args["--model"]
    paramset = load_settings(model_dir)
    run_args = {
        "nr_inference_workers": int(args["--nr_inference_workers"]),
        "nr_post_proc_workers": int(args["--nr_post_proc_workers"]),
        "batch_size": int(args["--batch_size"]),
        "input_dir": args["--input_dir"],
        "output_dir": output_dir,
        "patch_input_shape": 1168 if args["--dense"]
        else int(args["--patch_input_shape"]),
        "patch_output_shape": 864 if args["--dense"]
        else int(args["--patch_output_shape"]),
        "patch_output_overlap": 0,
        "postproc_list": list(DEFAULT_TARGET_LIST),
        "postproc_backend": args["--postproc_backend"],
        "tile_backend": args["--tile_backend"],
    }

    from .infer.tile import InferManager

    infer = InferManager(
        checkpoint_path="%s/weights.tar" % model_dir,
        decoder_dict=paramset.req_target_code,
        model_args=paramset.model_kwargs,
        device=device,
        mesh=mesh,
    )
    infer.process_file_list(run_args)


if __name__ == "__main__":
    main()
