"""A cohort of slides through the WSI engine, one after another, as a lab
runs ``run_infer_wsi`` over a slide list overnight.

Set-up writes the traffic's slides (seeded ``.svs`` files with JPEG tiles
and tissue-mask PNGs, as ``--msk_dir`` supplies them) and the seeded
model directory, builds the program's WSI manager as the CLI builds it
(``--gpu`` one card or a comma list, a mesh), and runs each slide once.
A unit is one slide, slide ``i % n`` of the traffic under a name of its
own, through ``InferManager.process_single_file`` with the CLI's
ioconfigs: the engine's per-slide log spans are captured.

The check, after the window: in the canvas each slide file's last run
left on disk, a seeded sample of its output windows against the
reference forward of the same input pixels (``inst_mean_gap``: the mean
gap of an INST probability over every sampled window; ``inst_window_gap``:
the largest of the windows' own means, so one wrong batch slot shows;
``inst_gap``: the widest single gap; ``class_flip_share``: the share of
class ids that differ). Then the post-processing, which the reference
works out from that canvas (the program's own state, step by step, after
the forward just checked): a seeded sample of grid tiles, the tiles whose
interiors hold the most records, whose nuclei are compared with the
slide's ``.dat`` records in the tile's interior, where no boundary pass
touches them (``nuclei_mismatch``: records of either side without an
equal box and centroid on the other, over the reference's count); and
every tissue region's glands and lumens (the mask's regions, their
channels at half scale) against the ``.dat``'s (``gland_lumen_mismatch``,
the same measure).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil

import numpy as np

from portbench.harness import disk_bytes
from portbench.reference import grid
from portbench.reference import postproc as ref_pp
from portbench.reference.flops import window_flops
from portbench.reference.model import Net, channel_map, forward_windows
from portbench.traffic.images import synthetic_image, tissue_mask, write_svs
from portbench.traffic.weights import make_weights

_SPAN = re.compile(r"^([A-Za-z &()]+): ([0-9.]+)$")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.spans = {}

    def emit(self, record):
        m = _SPAN.match(record.getMessage())
        if m:
            self.spans[m.group(1)] = float(m.group(2))


def write_model_dir(path: str, config: dict, weights) -> None:
    """``weights.tar`` (``{"desc": state dict}``) and ``settings.yml``
    (JSON, which YAML reads) as the CLIs load a model directory."""
    import torch

    os.makedirs(path, exist_ok=True)
    torch.save({"desc": weights}, os.path.join(path, "weights.tar"))
    with open(os.path.join(path, "settings.yml"), "w") as handle:
        json.dump({"dataset_kwargs": {
                       "req_target_code": config["target_code"]},
                   "model_kwargs": {
                       "encoder_backbone_name": config["encoder"],
                       "decoder_kwargs": config["decoders"],
                       "considered_tasks": list(config["decoders"])}},
                  handle)


def input_window(img: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
    """The ``size``-square window of ``img`` at top-left (x, y), zero
    where it leaves the image."""
    h, w = img.shape[:2]
    out = np.zeros((size, size, 3), np.uint8)
    ys, ye = max(y, 0), min(y + size, h)
    xs, xe = max(x, 0), min(x + size, w)
    if ys < ye and xs < xe:
        out[ys - y:ye - y, xs - x:xe - x] = img[ys:ye, xs:xe]
    return out


def window_gaps(prog: np.ndarray, ref: np.ndarray, chans) -> tuple:
    """(widest INST gap, summed INST gaps, INST values compared, class
    ids that differ, class ids compared) of one output window; ``prog``
    may be clipped at the slide's edge."""
    h, w = prog.shape[:2]
    ref = ref[:h, :w]
    gap, total, n, flips, count = 0.0, 0.0, 0, 0, 0
    for key, (s, e) in chans.items():
        if key.endswith("-INST"):
            diff = np.abs(prog[..., s:e] - ref[..., s:e])
            gap = max(gap, float(diff.max(initial=0.0)))
            total += float(diff.sum())
            n += diff.size
        else:
            flips += int((prog[..., s] != ref[..., s]).sum())
            count += prog[..., s].size
    return gap, total, n, flips, count


def dat_records(dat: dict, task: str = "Nuclei") -> list:
    return [tuple(float(v) for v in rec["box"])
            + tuple(float(v) for v in rec["centroid"])
            for rec in dat.get(task, {}).values()]


def region_records(canvas, mask, side: int, chans: dict, device) -> dict:
    """The reference's gland and lumen records of a slide (``.dat``
    coordinates) from its canvas: each tissue region's INST and TYPE
    channels at half scale, 512-padded, through the family, lumen kept
    inside glands."""
    out = {"Gland": [], "Lumen": []}
    for bounds, own in ref_pp.tissue_regions(mask, (side, side)):
        labels = {}
        for task in out:
            keys = [task + "-INST"] + ([task + "-TYPE"]
                                       if task + "-TYPE" in chans else [])
            picked = [c for k in keys for c in range(*chans[k])]
            plane = ref_pp.region_plane(canvas, bounds, own, picked, 0.5)
            h, w = plane.shape[:2]
            padded = ref_pp.pad_512(plane[..., :2])
            labels[task] = ref_pp.contour_labels(
                padded[..., 0], padded[..., 1], task.lower(), 0.5,
                device)[:h, :w]
        labels["Lumen"] = labels["Lumen"] * (labels["Gland"] > 0)
        for task in out:
            out[task] += ref_pp.records(labels[task], bounds[:2], 0.5)
    return out


def inside(rec, box) -> bool:
    x0, y0, x1, y1 = box
    return rec[0] >= x0 and rec[1] >= y0 and rec[2] <= x1 and rec[3] <= y1


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.work = cell.work_dir
        self.manager = None
        self.last = {}  # slide file -> the name of its last run

    # ------------------------------------------------------------ set-up
    def setup(self):
        import cv2
        import torch
        from cerberus_tpu_torch.config import load_settings
        from cerberus_tpu_torch.infer.wsi import InferManager
        from cerberus_tpu_torch.ops import cuda_build
        from cerberus_tpu_torch.parallel.mesh import gpu_flag_devices
        from cerberus_tpu_torch.wsi.ioconfig import (
            make_inference_ioconfig, make_postproc_ioconfig)

        cfg, tr, seed = self.config, self.traffic, self.cell.seed
        shutil.rmtree(self.work, ignore_errors=True)
        for sub in ("input", "mask", "out/dat", "out/tissue", "log"):
            os.makedirs(os.path.join(self.work, sub))
        self.dev = torch.device(self.cell.device, 0) \
            if self.cell.device == "cuda" else torch.device("cpu")
        if self.cell.device == "cuda":
            cuda_build.build_all()
        self._launches = cuda_build.launch_counts

        side = int(tr["slide_px"])
        win_in, win_out = int(cfg["patch_input"]), int(cfg["patch_output"])
        self.slides = []
        for k, spec in enumerate(tr["slides"]):
            rng = np.random.default_rng([seed % 2 ** 63, k])
            path = os.path.join(self.work, "input", "slide%d.svs" % k)
            truth = write_svs(path, synthetic_image((side, side), rng),
                              int(tr["tile_px"]), int(tr["jpeg_quality"]),
                              float(tr["mpp"]))
            mask = tissue_mask((side // tr["mask_ds"],) * 2, spec["tissue"])
            mask_path = os.path.join(self.work, "mask", "slide%d.png" % k)
            cv2.imwrite(mask_path, mask * 255)
            self.slides.append({"path": path, "mask_path": mask_path,
                                "truth": truth, "mask": mask,
                                "windows": grid.slide_windows(
                                    side, side, win_in, win_out, mask)})
        self.flops = window_flops(cfg)

        weights = make_weights(cfg, seed, self.dev,
                               int(tr["jpeg_quality"]))
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        model_dir = os.path.join(self.work, "model")
        write_model_dir(model_dir, cfg, self.weights)

        run = dict(tr["run"])
        paramset = load_settings(model_dir)
        gpu = run.pop("gpu")
        device, mesh = (gpu_flag_devices(gpu) if self.cell.device == "cuda"
                        else ("cpu", None))
        self.manager = InferManager(
            checkpoint_path=os.path.join(model_dir, "weights.tar"),
            decoder_dict=paramset.req_target_code,
            model_args=paramset.model_kwargs, device=device, mesh=mesh,
            output_dir=os.path.join(self.work, "out"),
            logging_dir=os.path.join(self.work, "log"),
            patch_input_shape=win_in, patch_output_shape=win_out, **run)
        n_heads = len(self.manager.cfg.active_decoder_kwargs)
        self.ioconfig = make_inference_ioconfig(
            run["wsi_proc_mag"], n_heads, tile_shape=run["chunk_shape"],
            margin=run["ambiguous_size"], patch_input=win_in,
            patch_output=win_out)
        self.ioconfig_pp = make_postproc_ioconfig(
            run["wsi_proc_mag"], tile_shape=run["tile_shape"],
            margin=run["ambiguous_size"])
        self.capture = _Capture()
        logger = logging.getLogger("portbench.wsi")
        logger.handlers = [self.capture]
        logger.setLevel(logging.INFO)
        logger.propagate = False
        self.manager.logger = logger
        for k in range(len(self.slides)):  # every shape the window runs
            self.unit(-1 - k)

    # ------------------------------------------------------------ units
    def unit(self, i: int) -> dict:
        n = len(self.slides)
        k = i % n if i >= 0 else -1 - i
        name = ("s%05d_%d" % (i, k)) if i >= 0 else "warm%d" % k
        slide = self.slides[k]
        self.manager.cache_path = os.path.join(self.work, "cache", str(k))
        self.capture.spans = {}
        self.manager.process_single_file(
            self.ioconfig, self.ioconfig_pp, slide["path"],
            slide["mask_path"], name, os.path.join(self.work, "out"))
        if k in self.last:  # keep each slide file's last outputs only
            old = self.last[k]
            for sub, ext in (("dat", ".dat"), ("tissue", ".mat")):
                path = os.path.join(self.work, "out", sub, old + ext)
                if os.path.exists(path):
                    os.remove(path)
        self.last[k] = name
        side = int(self.traffic["slide_px"])
        out = os.path.join(self.work, "out")
        written = disk_bytes(self.manager.cache_path,
                             os.path.join(out, "dat", name + ".dat"),
                             os.path.join(out, "tissue", name + ".mat"))
        return {"mpx": side * side / 1e6, "bytes": written,
                "flops": len(slide["windows"]) * self.flops,
                "spans": dict(self.capture.spans)}

    def counters(self) -> dict:
        return dict(self._launches)

    def release(self):
        self.manager = None

    def close(self):
        shutil.rmtree(self.work, ignore_errors=True)

    # ------------------------------------------------------------ check
    def check(self, precision: str = "f32") -> dict:
        """The compared numbers of the slides' last runs; with
        ``precision="fp8"`` the control: the reference in fp8 put in the
        program's place (its canvas windows against the float32
        reference's; the records are then the reference's own)."""
        cfg, chk = self.config, self.traffic["check"]
        dev = self.dev
        win_in, win_out = int(cfg["patch_input"]), int(cfg["patch_output"])
        margin = (win_in - win_out) // 2
        sd = {k: v.to(dev) for k, v in self.weights.items()}
        net = Net(sd, cfg["encoder"], cfg["decoders"])
        low = Net(sd, cfg["encoder"], cfg["decoders"], "fp8") \
            if precision == "fp8" else None
        chans = channel_map(cfg["decoders"])
        n_s, n_e = chans["Nuclei-INST"]
        side = int(self.traffic["slide_px"])
        gap, gap_sum, gap_n, flips, classes = 0.0, 0.0, 0, 0, 0
        worst = 0.0
        missing = extra = n_ref = n_dat = 0
        gl_bad = gl_ref = 0
        for k, slide in enumerate(self.slides):
            name = self.last[k]
            cache = os.path.join(self.work, "cache", str(k), "raw.npy")
            canvas = np.load(cache, mmap_mode="r")
            rng = np.random.default_rng([self.cell.seed % 2 ** 63, 101, k])
            wins = slide["windows"]
            pick = np.sort(rng.choice(len(wins), min(int(chk["windows"]),
                                                    len(wins)),
                                      replace=False))
            inputs = np.stack([input_window(slide["truth"], x - margin,
                                            y - margin, win_in)
                               for x, y in wins[pick]])
            ref = forward_windows(net, inputs, win_out, dev)
            got = (forward_windows(low, inputs, win_out, dev)
                   if low is not None else
                   [np.asarray(canvas[y:y + win_out, x:x + win_out],
                               np.float32) for x, y in wins[pick]])
            for g, r in zip(got, ref):
                wg, ws, wn, wf, wc = window_gaps(g, r, chans)
                gap, gap_sum, gap_n = max(gap, wg), gap_sum + ws, gap_n + wn
                worst = max(worst, ws / max(wn, 1))
                flips, classes = flips + wf, classes + wc
            if low is not None:
                continue
            with open(os.path.join(self.work, "out", "dat", name + ".dat"),
                      "rb") as handle:
                written = pickle.load(handle)
            dat = dat_records(written)
            for task, ref_recs in region_records(
                    canvas, slide["mask"], side, chans, dev).items():
                m, e = ref_pp.unmatched(ref_recs, dat_records(written, task))
                gl_bad, gl_ref = gl_bad + m + e, gl_ref + len(ref_recs)
            n_dat += len(dat)
            tiles = grid.grid_tiles(side, side, self.traffic["run"]
                                    ["tile_shape"], win_out)
            inner = int(chk["interior_px"])

            def interior(t):
                return (t[0] + inner, t[1] + inner, t[2] - inner, t[3] - inner)

            # the tiles whose interiors hold the most records
            full = [t for t in tiles if t[2] - t[0] > 2 * inner
                    and t[3] - t[1] > 2 * inner]
            full.sort(key=lambda t: -sum(inside(r, interior(t)) for r in dat))
            for x0, y0, x1, y1 in full[:int(chk["tiles"])]:
                hp = grid.pad512(y1 - y0, win_out)
                wp = grid.pad512(x1 - x0, win_out)
                plane = np.zeros((hp, wp, n_e - n_s), np.float32)
                plane[:y1 - y0, :x1 - x0] = canvas[y0:y1, x0:x1, n_s:n_e]
                labels = ref_pp.nuclei_labels(plane[..., 0], plane[..., 1],
                                              dev)
                box = interior((x0, y0, x1, y1))
                ref_recs = [r for r in ref_pp.records(labels, (x0, y0))
                            if inside(r, box)]
                got_recs = [r for r in dat if inside(r, box)]
                m, e = ref_pp.unmatched(ref_recs, got_recs)
                missing, extra, n_ref = missing + m, extra + e, \
                    n_ref + len(ref_recs)
            del canvas
        out = {"inst_gap": gap, "inst_mean_gap": gap_sum / max(gap_n, 1),
               "inst_window_gap": worst,
               "class_flip_share": flips / max(classes, 1)}
        if low is None:
            out["nuclei_mismatch"] = (missing + extra) / max(n_ref, 1)
            out["nuclei_compared"] = n_ref
            out["nuclei_records"] = n_dat
            out["gland_lumen_mismatch"] = gl_bad / max(gl_ref, 1)
            out["gland_lumen_compared"] = gl_ref
        return out
