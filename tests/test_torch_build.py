"""The kernel library's build cache: keyed by a hash of the sources, and
published by an atomic rename, so processes sharing a build directory
never load a half-written library. A stand-in `nvcc` (a shell script
that links a one-function C library after a pause) lets this run
without a CUDA toolkit."""

import os
import subprocess
import sys

import pytest

from dynamont_tpu_torch import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep 1
printf 'int dynamont_probe(void) { return 7; }\\n' | cc -x c -shared -fPIC -o "$out" -
"""


def test_library_path_is_keyed_by_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setenv("DYNAMONT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build.library_path()
    assert first == _build.library_path()
    (src / "k.cu").write_text("// two\n")
    second = _build.library_path()
    assert second != first
    assert os.path.dirname(second) == str(tmp_path / "build")


def test_concurrent_builds_share_one_directory(tmp_path):
    if subprocess.run(["sh", "-c", "command -v cc"], capture_output=True).returncode:
        pytest.skip("needs a C compiler for the stand-in nvcc")
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_HOME=str(tmp_path / "cuda"),
               DYNAMONT_TORCH_BUILD_DIR=str(build))
    code = ("from dynamont_tpu_torch import _build\n"
            "lib = _build.load()\n"
            "print(lib._name, lib.dynamont_probe())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in results]
    lines = {out.strip() for out, _ in results}
    assert len(lines) == 1
    path, probe = lines.pop().rsplit(" ", 1)
    assert probe == "7"
    assert sorted(os.listdir(build)) == [os.path.basename(path)]
