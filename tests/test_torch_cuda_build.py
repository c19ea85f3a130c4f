"""``ops/cuda_build`` on the CPU side, the compiler replaced by a stand-in
``nvcc`` script: two processes that load a kernel at once build each
library once (the build lock), every library lands whole under its final
name, and a failed build still raises."""
import os
import stat
import sys
import textwrap

import pytest

from cerberus_tpu_torch.ops import cuda_build

import _torch_dist_workers as W
from _torch_ranks import run_ranks


def _fake_nvcc(root, log, fail=False):
    """A ``<root>/bin/nvcc`` that logs its call, sleeps, and writes its
    ``-o`` file (or fails)."""
    os.makedirs(root / "bin")
    script = root / "bin" / "nvcc"
    script.write_text(textwrap.dedent("""\
        #!%s
        import sys, time
        args = sys.argv[1:]
        with open(%r, "a") as log:
            log.write(args[-1] + "\\n")
        time.sleep(1.0)
        if %r:
            print("error: stand-in failure")
            sys.exit(1)
        with open(args[args.index("-o") + 1], "wb") as out:
            out.write(b"library")
        """ % (sys.executable, str(log), fail)))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(root)


def test_two_processes_loading_at_once_build_each_library_once(tmp_path):
    log = tmp_path / "nvcc.log"
    home = _fake_nvcc(tmp_path / "cuda", log)
    build = str(tmp_path / "build")
    paths = run_ranks(W.load_with_fake_nvcc, 2, (build, home), timeout_s=120)
    assert paths[0] == paths[1]
    assert os.path.basename(paths[0]).startswith("libcc_label_")
    calls = log.read_text().split()
    # one nvcc per kernel source, not one per process
    assert sorted(os.path.basename(c) for c in calls) == sorted(
        "%s.cu" % name for name in cuda_build.KERNELS)
    names = sorted(os.listdir(build))
    assert not [n for n in names if n.endswith(".tmp")]
    assert len([n for n in names if n.endswith(".so")]) == len(
        cuda_build.KERNELS)
    with open(paths[0], "rb") as handle:
        assert handle.read() == b"library"


def test_a_failed_build_raises(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path / "cuda", tmp_path / "nvcc.log", fail=True)
    monkeypatch.setenv("CUDA_HOME", home)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="stand-in failure"):
        cuda_build.build_all()
    assert not [n for n in os.listdir(tmp_path / "build")
                if n.endswith(".so")]
