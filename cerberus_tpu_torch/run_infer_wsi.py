"""run_infer_wsi.py (PyTorch + CUDA port)

Usage:
  run_infer_wsi.py [--gpu=<id>] [--model=<path>] [--nr_inference_workers=<n>] \
            [--nr_post_proc_workers=<n>] [--batch_size=<n>] [--tile_shape=<n>] [--chunk_shape=<n>] \
            [--ambiguous_size=<int>] [--wsi_proc_mag=<n>] [--wsi_file_ext=<str>] [--cache_path=<path>] \
            [--logging_dir=<path>] [--input_dir=<path>] [--msk_dir=<path>] [--output_dir=<path>] [--patch_input_shape=<n>] \
            [--patch_output_shape=<n>] [--wsi_bulk_idx=<n>] [--wsi_proc_step=<n>] [--save_thumb] [--save_mask] [--auto_mask] \
            [--postproc_backend=<str>] [--save_json] [--dense]
  run_infer_wsi.py (-h | --help)
  run_infer_wsi.py --version

Options:
  -h --help                   Show this string.
  --version                   Show version.
  --gpu=<id>                  GPU to run on (cuda:<id>). [default: 0]
  --model=<path>              Path to the model directory (weights.tar + settings.yml).
  --nr_inference_workers=<n>  Number of workers during inference. [default: 0]
  --nr_post_proc_workers=<n>  Number of workers during post-processing. [default: 0]
  --batch_size=<n>            Batch size. [default: 30]
  --tile_shape=<n>            Shape of tile for processing. [default: 2048]
  --chunk_shape=<n>           Shape of tile for processing. [default: 15000]
  --ambiguous_size=<int>      Define ambiguous region along tiling grid to perform re-post processing. [default: 64]
  --wsi_proc_mag=<n>          Microns per pixel used for WSI processing. [default: 0.5]
  --wsi_file_ext=<str>        File extension of WSIs to process. [default: .svs]
  --cache_path=<path>         Path for cache. Should be placed on SSD with at least 100GB. [default: cache/]
  --logging_dir=<path>        Path for python logging. [default: logging/]
  --input_dir=<path>          Path to input data directory. Assumes the files are not nested within directory.
  --msk_dir=<path>            Path to directory containing tissue masks. Should have the same name as corresponding WSIs.
  --output_dir=<path>         Path to output data directory. Will create automtically if doesn't exist. [default: output/]
  --patch_input_shape=<n>     Shape of input patch to the network- Assume square shape. [default: 448]
  --patch_output_shape=<n>    Shape of network output- Assume square shape. [default: 144]
  --dense                     Dense inference: 1168->864 windows (~3x fewer FLOPs per output px at the same 152 px margin). Overrides the patch shape flags; use --batch_size=16 or less (windows are 6.8x larger)
  --wsi_bulk_idx=<n>          Index for batch processing. Indexing is from 0 to n-1. [default: 1]
  --wsi_proc_step=<n>         Increments for batch WSI processing. [default: 10]
  --save_thumb                Whether to save the slide thumbnail
  --save_mask                 Whether to save the slide mask
  --auto_mask                 Generate tissue masks automatically (stain-entropy Otsu) for slides without one
  --postproc_backend=<str>    Instance post-processing backend: gpu (the CUDA families on the card; tpu is an alias) or cpu (the scipy/cv2 families on the host). The default deliberately differs from the JAX CLI's cpu: --postproc_backend=cpu reproduces the reference's run. [default: gpu]
  --save_json                 Also export per-slide instance dictionaries as json/<name>.json

Run as ``python -m cerberus_tpu_torch.run_infer_wsi``. The flags are those
of the JAX package's ``run_infer_wsi.py``, with its bulk-sharding contract:
slides [(bulk_idx-1)*step, bulk_idx*step) of the sorted list are processed
per invocation, the cache path is suffixed with the bulk index, and slides
lacking a mask are skipped when --msk_dir is given. ``.npy`` pyramid
directories (holding ``level_0.npy``) in the input directory are slides
too. ``--postproc_backend=gpu`` runs the resident loop (inference and
post-processing on the card); ``CERBERUS_RESIDENT=0`` selects the legacy
host-canvas loop with the same CUDA families, and
``--postproc_backend=cpu`` (the JAX CLI's default, the reference's run)
the legacy loop with the scipy/cv2 families on the host.
``--nr_post_proc_workers`` sizes the cpu backend's process pool (0: in
this process); ``--nr_inference_workers`` the legacy loop's read threads
for readers without a batched read.
"""
from __future__ import annotations

import glob
import os

from .config import DEFAULT_TARGET_LIST, load_settings
from .utils import rm_n_mkdir
from .utils.cli import docopt
from .utils.debug import configure_from_env, default_device


def slide_lists(input_dir, wsi_file_ext, msk_dir, bulk_idx: int, step: int):
    """The (slides, masks) this invocation processes."""
    wsi_file_list = glob.glob(f"{input_dir}/*{wsi_file_ext}")
    wsi_file_list += [p for p in glob.glob(f"{input_dir}/*")
                      if os.path.isdir(p)
                      and os.path.exists(os.path.join(p, "level_0.npy"))]
    wsi_list, mask_list = [], []
    for wsi_filename in sorted(set(wsi_file_list)):
        wsi_basename = os.path.splitext(os.path.basename(wsi_filename))[0]
        if not msk_dir:
            wsi_list.append(wsi_filename)
            mask_list.append(None)
        elif os.path.isfile(msk_dir + wsi_basename + ".png"):
            wsi_list.append(wsi_filename)
            mask_list.append(msk_dir + wsi_basename + ".png")
    start_idx, end_idx = (bulk_idx - 1) * step, bulk_idx * step
    return wsi_list[start_idx:end_idx], mask_list[start_idx:end_idx]


def main(argv=None, device=None) -> None:
    """Parse ``argv`` and run WSI inference. ``device`` overrides ``--gpu``
    (the tests pass ``device="cpu"``), as ``CERBERUS_DEFAULT_DEVICE`` does
    when ``device`` is None."""
    configure_from_env()
    args = docopt(__doc__, argv=argv,
                  version="CoBi Gland Inference (cerberus-tpu-torch)")
    if device is None:
        device = default_device() or "cuda:%d" % int(
            str(args["--gpu"]).split(",")[0])

    output_dir = args["--output_dir"]
    logging_dir = args["--logging_dir"]
    if not os.path.exists(output_dir):
        rm_n_mkdir(output_dir)
    if not os.path.exists(logging_dir):
        rm_n_mkdir(logging_dir)

    wsi_list, mask_list = slide_lists(
        args["--input_dir"], args["--wsi_file_ext"], args["--msk_dir"],
        int(args["--wsi_bulk_idx"]), int(args["--wsi_proc_step"]))
    print("Number of WSIs in list:", len(wsi_list))

    model_dir = args["--model"]
    paramset = load_settings(model_dir)
    run_args = {
        "nr_inference_workers": int(args["--nr_inference_workers"]),
        "nr_post_proc_workers": int(args["--nr_post_proc_workers"]),
        "batch_size": int(args["--batch_size"]),
        "input_list": wsi_list,
        "mask_list": mask_list,
        "output_dir": output_dir,
        "patch_input_shape": 1168 if args["--dense"]
        else int(args["--patch_input_shape"]),
        "patch_output_shape": 864 if args["--dense"]
        else int(args["--patch_output_shape"]),
        "save_thumb": bool(args["--save_thumb"]),
        "save_mask": bool(args["--save_mask"]),
        "postproc_list": list(DEFAULT_TARGET_LIST),
        "tile_shape": int(args["--tile_shape"]),
        "chunk_shape": int(args["--chunk_shape"]),
        "ambiguous_size": int(args["--ambiguous_size"]),
        "cache_path": args["--cache_path"] + args["--wsi_bulk_idx"],
        "logging_dir": logging_dir,
        "wsi_proc_mag": float(args["--wsi_proc_mag"]),
        "auto_mask": bool(args["--auto_mask"]),
        "postproc_backend": args["--postproc_backend"],
        "save_json": bool(args["--save_json"]),
    }

    from .infer.wsi import InferManager

    infer = InferManager(
        checkpoint_path="%s/weights.tar" % model_dir,
        decoder_dict=paramset.req_target_code,
        model_args=paramset.model_kwargs,
        device=device,
    )
    infer.process_wsi_list(run_args)


if __name__ == "__main__":
    main()
