"""The port's kernel build (``nerf_tpu_torch/ops/cuda/build.py``) on the CPU,
with a stand-in ``nvcc``: a script that writes its ``-o`` file and a line
of ptxas output after ``FAKE_NVCC_SLEEP`` seconds.

* ``start_shaped`` returns before its builds end; ``build_shaped`` then
  waits for them (starting no second ``nvcc`` for a library already being
  built) and returns each one's log;
* builds still running are killed, and leave no output, when the process
  ends (``_stop``, registered with ``atexit``).
"""

from __future__ import annotations

import os
import stat
import time

import pytest

from nerf_tpu_torch.ops.cuda import build
from nerf_tpu_torch.ops.cuda.siren_plan import plan
from tests.torch_port_threads import one_intra_op_thread  # noqa: F401

FAKE = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "started $out" >> "$FAKE_NVCC_STARTS"
sleep "$FAKE_NVCC_SLEEP"
echo "ptxas info    : Used 42 registers"
touch "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    tool = tmp_path / "nvcc"
    tool.write_text(FAKE)
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR)
    starts = tmp_path / "starts.txt"
    starts.write_text("")
    monkeypatch.setattr(build, "_nvcc", lambda: str(tool))
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("FAKE_NVCC_STARTS", str(starts))
    yield starts
    build._stop()


def test_started_builds_are_waited_for_not_restarted(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1")
    wide = plan(512, 32).builds
    t0 = time.perf_counter()
    build.start_shaped(wide, nice=19)
    assert time.perf_counter() - t0 < 1.0
    assert len(build._RUNNING) == len(wide)
    infos = build.build_shaped(wide)
    assert not build._RUNNING
    starts = fake_nvcc.read_text().splitlines()
    # each wide library once, and the default shape's beside them
    assert len(starts) == len(wide) + len(build.LIBS)
    assert len(set(starts)) == len(starts)
    for info, (name, tag, _) in zip(infos, wide):
        assert info.name == name and tag in info.path.name and info.path.exists()
        assert "Used 42 registers" in info.log
    assert not [p for p in build._BUILD_DIR.iterdir() if p.suffix == ".log" or ".tmp" in p.name]
    again = build.build_shaped(wide)
    assert [i.log for i in again] == ["cached"] * len(wide)
    assert len(fake_nvcc.read_text().splitlines()) == len(starts)


def test_builds_running_at_exit_are_killed(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "30")
    wide = plan(1024, 64).builds
    build.start_shaped(wide, nice=19)
    procs = [entry[0] for entry in build._RUNNING.values()]
    assert len(procs) == len(wide)
    t0 = time.perf_counter()
    build._stop()
    assert time.perf_counter() - t0 < 10.0
    assert not build._RUNNING
    assert all(p.poll() is not None for p in procs)
    assert not [p for p in os.listdir(build._BUILD_DIR)]
