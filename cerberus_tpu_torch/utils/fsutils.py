"""Filesystem helpers (a copy of ``cerberus_tpu/utils/fsutils.py``).

Behavioral parity with the reference's ``misc/utils.py`` (rm_n_mkdir
``misc/utils.py:113-116``, mkdir ``:107-110``, recur_find_ext ``:250-265``,
get_files ``:119-130``, save_json ``:329-345``), and ``load_dat`` for the
``.dat`` payloads of patch evaluation and training.
"""
from __future__ import annotations

import glob
import json
import os
import pathlib
import pickle
import shutil

import numpy as np


def mkdir(dir_path: str) -> None:
    if not os.path.isdir(dir_path):
        os.makedirs(dir_path)


def rm_n_mkdir(dir_path: str) -> None:
    if os.path.isdir(dir_path):
        shutil.rmtree(dir_path)
    os.makedirs(dir_path)


def recur_find_ext(root_dir: str, ext_list) -> list:
    """Recursively find all files whose suffix is in ``ext_list`` (e.g.
    ``['.png']``). The returned list is sorted."""
    file_path_list = []
    for cur_path, _dir_list, file_list in os.walk(root_dir):
        for file_name in file_list:
            file_ext = pathlib.Path(file_name).suffix
            if file_ext in ext_list:
                file_path_list.append(os.path.join(cur_path, file_name))
    file_path_list.sort()
    return file_path_list


def get_files(data_dir_list, data_ext) -> list:
    """All files with extension ``data_ext`` in each directory, sorted
    per-directory then concatenated."""
    data_files = []
    for sub_dir in data_dir_list:
        files_list = glob.glob(sub_dir + "/*" + data_ext)
        files_list.sort()
        data_files.extend(files_list)
    return data_files


def _jsonable(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


def save_json(path: str, old_dict: dict, mag=None) -> None:
    """Serialize nested ``{target: {inst_id: info}}`` instance dictionaries to
    JSON with the same ``{"mag": ..., "instances": ...}`` envelope as the
    reference (``misc/utils.py:329-345``)."""
    new_dict = {}
    for target, old_dict_target in old_dict.items():
        new_dict_tmp = {}
        for inst_id, inst_info in old_dict_target.items():
            new_dict_tmp[inst_id] = {
                name: _jsonable(value) for name, value in inst_info.items()
            }
        new_dict[target] = new_dict_tmp
    json_dict = {"mag": mag, "instances": new_dict}
    with open(path, "w") as handle:
        json.dump(json_dict, handle)


def load_dat(path: str) -> dict:
    """One ``.dat`` payload of ``{"img", ...}``: a plain pickle, else a
    joblib file (joblib imported only then)."""
    with open(path, "rb") as handle:
        try:
            info = pickle.load(handle)
        except (pickle.UnpicklingError, EOFError, ImportError,
                AttributeError, ValueError, TypeError, IndexError,
                KeyError):
            info = None  # not a plain pickle (a joblib payload, say)
    if isinstance(info, dict) and isinstance(info.get("img"), np.ndarray):
        return info
    try:
        import joblib
    except ImportError as exc:
        raise ImportError(
            "%s is not a plain pickle of {'img', 'ann'}; reading it as a "
            "joblib payload needs joblib, which is not installed" % path) \
            from exc
    return joblib.load(path)
