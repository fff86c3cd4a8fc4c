"""The port's multi-rank checks on the CPU: tests/_torch_distributed_main.py
in ONE subprocess of 4 gloo ranks (``torch.multiprocessing``; the ranks
meet through a ``file://`` store under ``tmp_path``, never a fixed port,
so parallel test workers cannot collide), ~10 s.  Each test reads its
check's line from that run:

- the mesh plumbing: per-axis process groups, ``axis_index``,
  ``maybe_psum`` / ``maybe_all_gather``, rows split over ``("pod",
  "data")``, ``make_mesh_for`` over the ranks, ``make_production_mesh``
  refused off its 256 ranks;
- ``compressed_psum`` against a numpy replay of every rank's math;
- the manual data-parallel step on reduced spiking-YOLO over (pod, data)
  = (2, 2): losses finite and falling over six steps (reference
  ``tests/_distributed_main.py:110-147``), and its first step equal to a
  one-process replay of per-shard gradients, pmean and int8 over pod;
- the detector's data-parallel step at world 2 and 4 within 1e-5 of one
  process, every rank's state bit-equal (reference ``:150-193``); a
  batch whose shards hold different box counts; ``train_detector`` with
  ``shard`` under the group;
- ``pipeline_forward`` (S = 4, M = 8) and ``bubble_fraction``
  (reference ``:196-215``);

then the launcher under ``torchrun`` with 2 gloo ranks (~8 s).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKS = ("mesh_plumbing", "compressed_psum", "manual_dp_losses_fall",
          "manual_dp_step_replay", "detector_dp_world2", "detector_dp_world4",
          "detector_dp_uneven_boxes", "train_detector_dp", "pipeline")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_distributed_main.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=240)
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("CHECK "):
            name, _, verdict = ln[len("CHECK "):].partition(" ")
            lines[name] = verdict
    return proc, lines


def test_all_checks_ran(run):
    proc, lines = run
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ALL TORCH DISTRIBUTED CHECKS RAN" in proc.stdout
    assert sorted(lines) == sorted(CHECKS), proc.stdout


@pytest.mark.parametrize("check", CHECKS)
def test_check(run, check):
    proc, lines = run
    assert check in lines, proc.stdout + proc.stderr[-4000:]
    assert lines[check] == "ok", lines[check]


def test_launch_train_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train`` on the
    CPU (gloo; ``--standalone`` picks a free localhost port): the ranks
    train the reduced detector data-parallel, rank 0 alone prints and
    writes the checkpoints."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--reduced", "--device", "cpu", "--batch", "4", "--steps", "2",
         "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final: step=1 loss=") == 1, proc.stdout
    assert "data-parallel over 2 ranks" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_000000001",
                                            "step_000000002"]


@pytest.mark.parametrize("backend,why,refused", [
    ("gloo", "[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:339] "
             "writev [127.0.0.1]:42410: Bad address", True),
    ("gloo", "[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:547] "
             "Connection closed by peer [127.0.0.1]:24522", True),
    ("nccl", "[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:339] "
             "writev [127.0.0.1]:42410: Bad address", False),
    ("gloo", "mat1 and mat2 shapes cannot be multiplied (2x16 and 8x16)",
     False),
    ("gloo", "", False),
])
def test_chip_smoke_pipeline_not_run_only_for_gloo_transport(backend, why,
                                                             refused):
    """``chip_smoke.py``'s pipeline check on the card is "not run" only
    where gloo's TCP transport failed on CUDA tensors; any other error,
    and every NCCL error, fails the phase."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert chip_smoke.gloo_refused_cuda(backend, why) is refused
