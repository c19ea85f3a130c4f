"""Directory jobs through the tile engine, as a pathologist sends a folder
of regions exported from a viewer to ``run_infer_tile``.

Set-up writes the traffic's PNG regions (the same sizes in every seed,
seeded content) and the seeded model directory, builds the program's
tile manager as the CLI builds it, and runs one job. A unit is one job:
``InferManager.process_file_list`` with the CLI's run arguments over the
whole folder, into an emptied output directory (the CLI skips files
whose outputs exist).

The check, after the window, on a seeded sample of the last job's
images that always holds the largest. The forward: the reference forward
over the image's reflect-padded window grid, stitched, against the class
ids the job wrote (``type_map`` of the nuclei and gland ``.mat`` files,
``pclass``), as ``class_flip_share``, and against the INST probabilities
of the canvas that the job handed to its post-processing (the driver
keeps a reference to it, no copy, while the job runs), each output
window's mean gap: ``inst_mean_gap`` the mean of these over the sample,
``inst_window_gap`` the largest. The post-processing: the reference's nuclei,
gland and lumen families on that canvas (the program's own state, step
by step, after the forward just checked) against the ``inst_map`` of
each ``.mat`` file (``label_mismatch``: pixels whose id differs, over
the reference's foreground). The records: every written ``id`` and
``type`` of the nuclei and gland ``.mat`` files against the records the
written maps imply (every instance id has a record, typed by the
majority of its pixels' class ids, background giving way to the
runner-up), as ``record_mismatch``.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from portbench.harness import disk_bytes
from portbench.reference import grid
from portbench.reference import postproc as ref_pp
from portbench.reference.flops import window_flops
from portbench.reference.model import Net, channel_map, forward_windows
from portbench.traffic.images import synthetic_image, write_png
from portbench.traffic.weights import make_weights
from portbench.drivers.wsi_cohort import write_model_dir


def reference_canvas(net, img, win_in, win_out, device) -> np.ndarray:
    """The reference's (h, w, C) canvas of one image."""
    padded, tl = grid.tile_windows(img, win_in, win_out)
    outs = forward_windows(net, np.stack([padded[y:y + win_in, x:x + win_in]
                                          for y, x in tl]), win_out, device)
    h, w = img.shape[:2]
    canvas = np.zeros((int(tl[:, 0].max()) + win_out,
                       int(tl[:, 1].max()) + win_out, outs.shape[-1]),
                      np.float32)
    for (y, x), out in zip(tl, outs):
        canvas[y:y + win_out, x:x + win_out] = out
    return canvas[:h, :w]


def reference_labels(canvas: np.ndarray, chans: dict, device) -> dict:
    """The reference's nuclei, gland and lumen ids of an (h, w, C) canvas
    (compacted; lumen kept inside glands)."""
    def inst(task):
        s = chans[task + "-INST"][0]
        return canvas[..., s], canvas[..., s + 1]

    out = {"Nuclei": ref_pp.compact(ref_pp.nuclei_labels(*inst("Nuclei"),
                                                         device))}
    for task in ("Gland", "Lumen"):
        out[task] = ref_pp.contour_labels(*inst(task), task.lower(), 1.0,
                                          device)
    out["Lumen"] = out["Lumen"] * (out["Gland"] > 0)
    return out


def window_means(got: np.ndarray, ref: np.ndarray, chans: dict,
                 size: int) -> np.ndarray:
    """The mean INST gap of each ``size``-square output window of the
    image (clipped at its edge)."""
    diff = np.concatenate([np.abs(got[..., s:e] - ref[..., s:e])
                           for k, (s, e) in chans.items()
                           if k.endswith("-INST")], axis=-1)
    h, w = diff.shape[:2]
    return np.array([diff[y:y + size, x:x + size].mean()
                     for y in range(0, h, size) for x in range(0, w, size)])


def record_mismatch(mat: dict) -> tuple:
    """(records that are missing, extra or typed otherwise, instance ids
    of the map) of one task's ``.mat``: its ``inst_map``, ``type_map``,
    ``id`` and ``type``."""
    inst = np.asarray(mat["inst_map"]).astype(np.int64)
    types = np.asarray(mat["type_map"]).astype(np.int64)
    ids = np.unique(inst)
    ids = ids[ids > 0]
    got = dict(zip(np.ravel(mat["id"]).astype(np.int64).tolist(),
                   np.ravel(mat["type"]).astype(np.int64).tolist()))
    fg = inst > 0
    n_types = int(types.max()) + 1 if types.size else 1
    counts = np.bincount(inst[fg] * n_types + types[fg],
                         minlength=(int(inst.max()) + 1) * n_types
                         ).reshape(-1, n_types)
    bad = len(set(got) - set(ids.tolist()))
    for i in ids.tolist():
        c = counts[i]
        order = sorted(range(n_types), key=lambda t: (-c[t], t))
        want = order[1] if order[0] == 0 and (c > 0).sum() > 1 else order[0]
        bad += got.get(i) != want
    return bad, len(ids)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.work = cell.work_dir
        self.manager = None

    def setup(self):
        import torch
        from cerberus_tpu_torch.config import load_settings
        from cerberus_tpu_torch.infer.tile import InferManager
        from cerberus_tpu_torch.ops import cuda_build
        from cerberus_tpu_torch.parallel.mesh import gpu_flag_devices

        cfg, tr, seed = self.config, self.traffic, self.cell.seed
        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(os.path.join(self.work, "input"))
        self.dev = torch.device(self.cell.device, 0) \
            if self.cell.device == "cuda" else torch.device("cpu")
        if self.cell.device == "cuda":
            cuda_build.build_all()
        self._launches = cuda_build.launch_counts
        win_in, win_out = int(cfg["patch_input"]), int(cfg["patch_output"])
        self.images = []
        n_windows = 0
        for k, side in enumerate(tr["sizes"]):
            rng = np.random.default_rng([seed % 2 ** 63, k])
            img = synthetic_image((side, side), rng)
            name = "region%02d" % k
            write_png(os.path.join(self.work, "input", name + ".png"), img)
            self.images.append((name, img))
            n_windows += len(grid.tile_windows(img, win_in, win_out)[1])
        self.mpx = sum(img.shape[0] * img.shape[1]
                       for _, img in self.images) / 1e6
        self.job_flops = n_windows * window_flops(cfg)

        weights = make_weights(cfg, seed, self.dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        model_dir = os.path.join(self.work, "model")
        write_model_dir(model_dir, cfg, self.weights)

        self.run_args = dict(tr["run"])
        gpu = self.run_args.pop("gpu")
        device, mesh = (gpu_flag_devices(gpu) if self.cell.device == "cuda"
                        else ("cpu", None))
        paramset = load_settings(model_dir)
        self.manager = InferManager(
            checkpoint_path=os.path.join(model_dir, "weights.tar"),
            decoder_dict=paramset.req_target_code,
            model_args=paramset.model_kwargs, device=device, mesh=mesh)
        self.run_args.update(input_dir=os.path.join(self.work, "input"),
                             patch_input_shape=win_in,
                             patch_output_shape=win_out)
        rng = np.random.default_rng([seed % 2 ** 63, 202])
        largest = int(np.argmax([img.size for _, img in self.images]))
        rest = [j for j in range(len(self.images)) if j != largest]
        self.pick = [largest] + [int(j) for j in rng.choice(
            rest, int(tr["check"]["images"]) - 1, replace=False)]
        self._observe()
        self.unit(-1)  # every shape the window runs

    def _observe(self):
        """Keep the canvases that the job hands to its post-processing
        for the sampled images (the files run in sorted order, the
        images' own)."""
        from cerberus_tpu_torch.infer import tile

        made = self._made = tile.post_process_canvas
        self.canvases = {}

        def observed(canvas, *args, **kwargs):
            j = self._calls
            self._calls += 1
            if j in self.pick:
                self.canvases[j] = canvas
            return made(canvas, *args, **kwargs)

        tile.post_process_canvas = observed

    def unit(self, i: int) -> dict:
        out = os.path.join(self.work, "out%d" % (i % 2))
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        self._calls = 0
        self.manager.process_file_list(dict(self.run_args, output_dir=out))
        self.last_out = out
        return {"mpx": self.mpx, "flops": self.job_flops, "spans": {},
                "bytes": disk_bytes(out)}

    def counters(self) -> dict:
        return dict(self._launches)

    def release(self):
        self.manager = None
        self.canvases = {j: c.float().cpu().numpy()
                         for j, c in self.canvases.items()}

    def close(self):
        from cerberus_tpu_torch.infer import tile

        if getattr(self, "_made", None) is not None:
            tile.post_process_canvas = self._made
        shutil.rmtree(self.work, ignore_errors=True)

    def check(self, precision: str = "f32") -> dict:
        """The compared numbers of the last job; with ``precision="fp8"``
        the control: the reference in fp8 put in the program's place (its
        canvas and class ids; the labels and records are then the
        reference's own)."""
        import scipy.io as sio

        cfg = self.config
        dev = self.dev
        win_in, win_out = int(cfg["patch_input"]), int(cfg["patch_output"])
        sd = {k: v.to(dev) for k, v in self.weights.items()}
        net = Net(sd, cfg["encoder"], cfg["decoders"])
        low = Net(sd, cfg["encoder"], cfg["decoders"], "fp8") \
            if precision == "fp8" else None
        chans = channel_map(cfg["decoders"])
        flips = classes = bad = n_ids = wrong_px = ref_px = 0
        means = []
        for j in self.pick:
            name, img = self.images[j]
            ref = reference_canvas(net, img, win_in, win_out, dev)
            if low is not None:
                got = reference_canvas(low, img, win_in, win_out, dev)
                maps = {key: got[..., chans[key][0]] for key in
                        ("Nuclei-TYPE", "Gland-TYPE", "Patch-Class")
                        if key in chans}
            else:
                def mat(task):
                    return sio.loadmat(os.path.join(
                        self.last_out, "%s_mat" % task, name + ".mat"))

                got = self.canvases[j]
                if got.shape[:2] != img.shape[:2]:
                    raise ValueError("canvas %s of %s is not the image's"
                                     % (got.shape, name))
                mats = {task: mat(task.lower())
                        for task in ("Nuclei", "Gland", "Lumen")}
                for task in ("Nuclei", "Gland"):
                    b, n = record_mismatch(mats[task])
                    bad, n_ids = bad + b, n_ids + n
                for task, want in reference_labels(got, chans, dev).items():
                    wrong_px += int((mats[task]["inst_map"] != want).sum())
                    ref_px += int((want > 0).sum())
                maps = {"Nuclei-TYPE": mats["Nuclei"]["type_map"],
                        "Gland-TYPE": mats["Gland"]["type_map"]}
                if "Patch-Class" in chans:
                    maps["Patch-Class"] = mat("pclass")["pclass"]
            for key, got_map in maps.items():
                ref_map = ref[..., chans[key][0]]
                flips += int((np.asarray(got_map) != ref_map).sum())
                classes += ref_map.size
            means.append(window_means(got, ref, chans, win_out))
        means = np.concatenate(means)
        out = {"class_flip_share": flips / max(classes, 1),
               "inst_mean_gap": float(means.mean()),
               "inst_window_gap": float(means.max())}
        if low is None:
            out["label_mismatch"] = wrong_px / max(ref_px, 1)
            out["record_mismatch"] = bad / max(n_ids, 1)
            out["records_compared"] = n_ids
        return out
