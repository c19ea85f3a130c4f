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
  --gpu=<id>                  GPU to run on (cuda:<id>). [default: 0]
  --model=<path>              Path to the model directory (weights.tar + settings.yml).
  --nr_inference_workers=<n>  Number of workers during inference. [default: 0]
  --nr_post_proc_workers=<n>  Number of workers during post-processing. [default: 0]
  --batch_size=<n>            Batch size. [default: 10]
  --input_dir=<path>          Path to input data directory. Assumes the files are not nested within directory.
  --output_dir=<path>         Path to output data directory. Will create automtically if doesn't exist. [default: output/]
  --patch_input_shape=<n>     Shape of input patch to the network- Assume square shape. [default: 448]
  --patch_output_shape=<n>    Shape of network output- Assume square shape. [default: 144]
  --dense                     Dense inference windows (not ported yet).
  --postproc_backend=<str>    Instance post-processing backend: gpu (on the card; tpu is an alias). cpu is not ported yet. [default: gpu]
  --tile_backend=<str>        Tile engine: host (only host is ported). [default: host]

Run as ``python -m cerberus_tpu_torch.run_infer_tile``. The flags are those
of the JAX package's ``run_infer_tile.py``. The worker-count flags are
accepted for compatibility; inference and post-processing run in-process
on the card.
"""
from __future__ import annotations

import os

from .config import DEFAULT_TARGET_LIST, load_settings
from .utils import rm_n_mkdir
from .utils.cli import docopt


def main(argv=None, device=None) -> None:
    """Parse ``argv`` and run tile inference. ``device`` overrides
    ``--gpu`` (the tests pass ``device="cpu"``)."""
    args = docopt(__doc__, argv=argv,
                  version="CoBi Gland Inference (cerberus-tpu-torch)")
    if args["--dense"]:
        raise NotImplementedError("--dense is not ported yet")
    if args["--postproc_backend"] == "cpu":
        raise NotImplementedError(
            "--postproc_backend=cpu (the scipy oracle) is not ported yet; "
            "use gpu")
    if device is None:
        device = "cuda:%d" % int(str(args["--gpu"]).split(",")[0])

    output_dir = args["--output_dir"]
    if not os.path.exists(output_dir):
        rm_n_mkdir(output_dir)
    model_dir = args["--model"]
    paramset = load_settings(model_dir)
    run_args = {
        "batch_size": int(args["--batch_size"]),
        "input_dir": args["--input_dir"],
        "output_dir": output_dir,
        "patch_input_shape": int(args["--patch_input_shape"]),
        "patch_output_shape": int(args["--patch_output_shape"]),
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
    )
    infer.process_file_list(run_args)


if __name__ == "__main__":
    main()
