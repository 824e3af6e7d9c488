"""Teacher distillation of nerf_tpu_torch (``train/distill.py``) through
its loops: the chunk logs and the hand-off (step 0, fresh Adam),
``load_teacher`` reading the checkpoint's metadata, and ``fit`` distilling
and then fine-tuning from step 0, with a resume that skips distillation,
and the train CLI. All on the CPU (the student's field kernels through
their plain versions), from a small NeRF teacher trained here; the loss
against nerf_tpu's is in ``test_torch_port_distill.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import parse_config_file
from nerf_tpu_torch.models.kilonerf import KiloNeRFModel
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.ops.cuda.fused_kilonerf import KiloNeRFField
from nerf_tpu_torch.train.distill import load_teacher, run_distillation
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train.step import fused_field_for
from nerf_tpu_torch.utils.checkpoint import read_metadata, save_checkpoint

DOMAIN = (-2.75, -1.25)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("distill"))
    make_synthetic_blender_scene(os.path.join(r, "scene"), h=16, w=16,
                                 num_train=4, num_val=1, num_test=1)
    return r


def _cfg(root, **kw):
    base = parse_config_file(os.path.join(REPO, "configs", "lego_siren.txt"))
    opts = dict(dataset_path=os.path.join(root, "scene"), num_random_rays=64,
                chunk_size=128, num_samples=8, hidden_dim=32, pos_encoding_dim=2,
                dir_encoding_dim=1, compute_dtype="float32", num_iters=6,
                log_interval=1, val_interval=100, save_interval=100,
                log_dir=os.path.join(root, "logs"))
    opts.update(kw)
    return dataclasses.replace(base, **opts)


@pytest.fixture(scope="module")
def teacher_ckpt(root):
    """A small NeRF teacher trained on the module path (use_pallas =
    false, as a hidden-32 NeRF runs in the JAX package too)."""
    cfg = _cfg(root, model_type="nerf", use_pallas=False,
               save_path=os.path.join(root, "teacher"))
    fit(cfg, device="cpu", log=lambda *_: None)
    return os.path.join(cfg.save_path, "nerf_model_000006")


def test_run_distillation_logs_chunks_and_hands_off(root, teacher_ckpt):
    """150 steps run as chunks of 100 and 50, one "[Distill] done/total
    loss: ... (rgb ..., sigma ...)" line each and every step's loss as a
    ``distill_loss`` scalar; the state comes back at step 0 with a fresh
    Adam (count 0, zero moments) over the same, moved, parameters."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=2, distill_from=teacher_ckpt,
               distill_steps=150, distill_batch=256, learning_rate=2e-3)
    state = create_train_state(cfg, device="cpu")
    start = [p.detach().clone() for p in state.params.parameters()]
    lines, scalars = [], []
    out = run_distillation(cfg, state, device="cpu", log=lines.append,
                           log_scalar=lambda tag, v, step: scalars.append((tag, step, v)))
    assert [line.split("  ")[0] for line in lines] == ["[Distill] 100/150",
                                                        "[Distill] 150/150"]
    for line in lines:
        assert re.match(r"\[Distill\] \d+/150  loss: \d+\.\d{6}  "
                        r"\(rgb \d+\.\d{6}, sigma \d+\.\d{4}\)$", line), line
    assert [s[1] for s in scalars] == list(range(150))
    assert {s[0] for s in scalars} == {"distill_loss"}
    assert scalars[-1][2] < scalars[0][2]
    assert out.step == 0 and out.params is state.params
    assert out.optimizer.count == 0
    assert all(float(m.abs().max()) == 0.0 for m in out.optimizer.mu + out.optimizer.nu)
    assert out.optimizer.params == list(state.params.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(start, state.params.parameters()))


def test_load_teacher_reads_the_metadata(root, teacher_ckpt):
    """The teacher is rebuilt from the checkpoint's model_type and
    grid_res over the same config: a NeRF from a kilonerf config (its
    module, frozen), and a KiloNeRF of grid 2 under a config of grid 3 (its
    field kernels, weights packed once)."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=3)
    t = load_teacher(cfg, teacher_ckpt, device="cpu")
    assert isinstance(t, NeRFModel) and not any(p.requires_grad for p in t.parameters())
    assert isinstance(load_teacher(dataclasses.replace(cfg, use_pallas=False),
                                   teacher_ckpt, device="cpu"), NeRFModel)
    ks = KiloNeRFModel(grid_res=2, hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1,
                       domain=DOMAIN, generator=torch.Generator().manual_seed(5))
    path = save_checkpoint(ks, None, os.path.join(root, "kt"), "kilonerf", 0)
    assert read_metadata(path)["grid_res"] == 2
    kt = load_teacher(cfg, path, device="cpu")
    assert isinstance(kt, KiloNeRFField) and kt.packed is not None
    assert kt.model.grid_res == 2
    pts = torch.rand(50, 3) * 1.5 - 2.75
    d = torch.nn.functional.normalize(torch.randn(50, 3), dim=-1)
    with torch.no_grad():
        a, b = kt(pts, d), ks(pts, d)
    torch.testing.assert_close(a[0], b[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(a[1], b[1], atol=1e-4, rtol=0)
    # a NeRF at hidden 256 takes nerf_tpu's field kernel there: the module
    # on the CPU (the card takes the port's NerfField)
    big = NeRFModel(hidden_dim=256)
    assert fused_field_for(big) is big


def test_fit_distills_then_finetunes_and_resume_skips_it(root, teacher_ckpt):
    """fit() with distill_from: the distillation log lines, then the
    photometric loop from iteration 0 (state.step 5 after 5 iterations, as
    without distillation), grid_res in the checkpoint's metadata; a resume
    from the step-3 checkpoint runs no distillation and ends on the first
    run's parameters bit for bit (it repeats iteration 3 with the first
    run's step-4 draws, as the JAX loop's bookkeeping does). (cf. tests/test_distill.py::
    test_fit_distills_then_finetunes)."""
    cfg = _cfg(root, model_type="kilonerf", grid_res=2, distill_from=teacher_ckpt,
               distill_steps=12, distill_batch=256, num_iters=5, save_interval=3,
               save_path=os.path.join(root, "k"), log_dir=os.path.join(root, "klogs"))
    lines: list = []
    state = fit(cfg, device="cpu", log=lines.append)
    assert any(line.startswith("Distilling from teacher") for line in lines)
    assert [line.split("  ")[0] for line in lines if line.startswith("[Distill]")] == [
        "[Distill] 12/12"]
    iters = [int(m.group(1)) for line in lines
             for m in [re.search(r"\[Iter (\d+)\]", line)] if m]
    assert iters == [0, 1, 2, 3, 4]
    assert state.step == 5 and state.optimizer.count == 5
    assert np.isfinite(float(sum(p.detach().sum() for p in state.params.parameters())))
    ckpt = os.path.join(cfg.save_path, "kilonerf_model_000003")
    assert read_metadata(ckpt)["grid_res"] == 2
    lines2: list = []
    resumed = fit(dataclasses.replace(cfg, grid_res=4, num_iters=4,
                                      save_path=os.path.join(root, "k2")),
                  resume_path=ckpt, device="cpu", log=lines2.append)
    assert not any("Distill" in line for line in lines2)
    assert resumed.params.grid_res == 2 and resumed.step == 5
    for (k, x), (_, y) in zip(resumed.params.state_dict().items(),
                              state.params.state_dict().items()):
        assert torch.equal(x, y), k


def test_train_cli_distills_and_trains_kilonerf(root, teacher_ckpt, capsys):
    """The train CLI on a config file with model_type = kilonerf and
    distill_from: distillation, then the photometric steps, on the CPU; a
    checkpoint with grid_res in its metadata."""
    from nerf_tpu_torch.cli import train_cli

    path = os.path.join(root, "kilo_cli.txt")
    save = os.path.join(root, "cli_models")
    with open(path, "w") as f:
        f.write("\n".join([
            f"dataset_path = {os.path.join(root, 'scene')}", "model_type = kilonerf",
            "hidden_dim = 32", "grid_res = 2", "pos_encoding_dim = 2",
            "dir_encoding_dim = 1", "num_random_rays = 64", "chunk_size = 128",
            "num_samples = 8", f"distill_from = {teacher_ckpt}", "distill_steps = 5",
            "distill_batch = 128", f"save_path = {save}",
            f"log_dir = {os.path.join(root, 'cli_logs')}", "log_interval = 1",
            "val_interval = 100", "save_interval = 100"]) + "\n")
    train_cli.main(["--config", path, "--device", "cpu", "--max-steps", "2"])
    out = capsys.readouterr().out
    assert "[Distill] 5/5" in out and "[Iter 0000001]" in out
    assert read_metadata(os.path.join(save, "kilonerf_model_000002"))["grid_res"] == 2
