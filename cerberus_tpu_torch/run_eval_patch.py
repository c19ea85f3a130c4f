"""run_eval_patch.py (PyTorch + CUDA port)

Usage:
  run_eval_patch.py [--gpu=<id>] [--model=<path>] [--batch_size=<n>] \
                    [--input_dir=<path>] [--patch_input_shape=<n>]
  run_eval_patch.py (-h | --help)

Options:
  -h --help                 Show this string.
  --gpu=<id>                GPU to run on (cuda:<id>). [default: 0]
  --model=<path>            Path to model directory (weights.tar + settings.yml).
  --batch_size=<n>          Batch size. [default: 32]
  --input_dir=<path>        Directory of .dat patch files ({"img", "ann"}; pickle or joblib).
  --patch_input_shape=<n>   Center-crop size fed to the network. [default: 144]

Run as ``python -m cerberus_tpu_torch.run_eval_patch``. The flags are those
of the JAX package's ``run_eval_patch.py``: it prints per-class AP,
accuracy and F1 and the row-normalised confusion matrix.
``CERBERUS_DEFAULT_DEVICE=cpu`` runs it without a card.
"""
from __future__ import annotations

from .config import load_settings
from .utils.cli import docopt
from .utils.debug import configure_from_env, default_device


def main(argv=None, device=None) -> dict:
    """Parse ``argv``, evaluate, return the metrics dict. ``device``
    overrides ``--gpu`` (and ``CERBERUS_DEFAULT_DEVICE``)."""
    configure_from_env()
    args = docopt(__doc__, argv=argv)
    if device is None:
        device = default_device() or "cuda:%d" % int(
            str(args["--gpu"]).split(",")[0])
    run_root_dir = args["--model"]
    paramset = load_settings(run_root_dir)

    from .infer.patch import InferManager

    infer = InferManager(
        checkpoint_path="%s/weights.tar" % run_root_dir,
        decoder_dict=paramset.req_target_code,
        model_args=paramset.model_kwargs,
        device=device,
    )
    return infer.process_file_list({
        "input_dir": args["--input_dir"],
        "batch_size": int(args["--batch_size"]),
        "patch_input_shape": int(args["--patch_input_shape"]),
    })


if __name__ == "__main__":
    main()
