"""The port's reference ``.pth`` interchange (``nerf_tpu_torch.utils.
torch_import`` / ``torch_export``) against nerf_tpu's (``nerf_tpu.utils.
torch_import`` / ``torch_export``) on the CPU, and the converter of nerf_tpu
checkpoints into port checkpoints (``tools/jax_checkpoint_to_torch.py``).

The same weights and Adam moments go into both packages (``load_jax_params``,
``load_jax_opt_state``); the exported files must be equal key for key and
value for value, and a ``.pth`` imported by either must give the same
parameters, step and Adam count."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.train.loop import fit as jax_fit
from nerf_tpu.train.state import create_train_state as jax_create_train_state
from nerf_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from nerf_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_tpu.utils import torch_export as jax_export
from nerf_tpu.utils import torch_import as jax_import
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.models.convert import (
    _flat_in_param_order,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from nerf_tpu_torch.models.nerf import NeRFModel
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.utils import torch_export, torch_import
from nerf_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    read_metadata,
    restore_train_state,
    save_train_state,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import jax_checkpoint_to_torch  # noqa: E402

STEP = 7        # the train state's step counter of the exported checkpoints
QUIET = lambda *a: None  # noqa: E731


def _kw(family: str) -> dict:
    """A small hierarchical config of ``family`` (the fine model separate)."""
    return dict(model_type=family, hidden_dim=32, num_samples=8, num_fine_samples=8,
                learning_rate=5e-3)


def _same(a, b, path: str = "") -> None:
    """``a`` equals ``b``: dicts key for key in the same order, tensors with
    ``torch.equal`` and the same dtype, everything else with ``==``."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module", params=["nerf", "siren"])
def pair(request, tmp_path_factory):
    """One nerf_tpu train state of a family with random Adam moments (count
    and step ``STEP``), saved by nerf_tpu, and the same state carried into
    a port checkpoint."""
    family = request.param
    root = str(tmp_path_factory.mktemp(f"pair_{family}"))
    jcfg = JaxConfig(**_kw(family))
    _, _, state = jax_create_train_state(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    adam = state.opt_state[0]
    adam = adam._replace(
        count=jnp.asarray(STEP, adam.count.dtype),
        mu=jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype), adam.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(rng.uniform(size=x.shape), x.dtype), adam.nu))
    state = state._replace(step=jnp.asarray(STEP, jnp.int32),
                           opt_state=(adam,) + tuple(state.opt_state[1:]))
    jckpt = jax_save_checkpoint(state, os.path.join(root, "jax"), family, 6)
    cfg = Config(**_kw(family))
    pst = create_train_state(cfg, device="cpu")
    host = jax.tree.map(np.asarray, state)
    load_jax_params(pst.params, host.params)
    load_jax_params(pst.fine_params, host.fine_params)
    load_jax_opt_state(pst.optimizer, host.opt_state)
    pst.step = STEP
    pckpt = save_train_state(pst, os.path.join(root, "port"), family, 6)
    return dict(family=family, root=root, jcfg=jcfg, cfg=cfg, jstate=host,
                jckpt=jckpt, pckpt=pckpt)


@pytest.mark.parametrize("use_fine", [False, True])
def test_export_matches_nerf_tpu(pair, use_fine):
    """The port's .pth of the same weights and moments equals nerf_tpu's,
    key for key and value for value: the step, the family, the state dict,
    the optimizer's param_groups and per-parameter state, the scheduler."""
    root = pair["root"]
    suffix = "fine" if use_fine else "coarse"
    got = torch_export.export_torch_checkpoint(
        pair["pckpt"], pair["cfg"], os.path.join(root, f"port_{suffix}.pth"), use_fine)
    want = jax_export.export_torch_checkpoint(
        pair["jckpt"], pair["jcfg"], os.path.join(root, f"jax_{suffix}.pth"), use_fine)
    got, want = (torch.load(p, weights_only=True) for p in (got, want))
    assert got["step"] == want["step"] == STEP
    assert sorted(got["optimizer_state_dict"]["state"]) == list(
        range(len(got["model_state_dict"])))
    _same(got, want)


def test_import_matches_nerf_tpu(pair):
    """A reference .pth (nerf_tpu's export of the pair's weights at step
    1234) imported by both packages: equal parameters (coarse, and the fine
    model equal to the coarse one), step and Adam count."""
    root, family = pair["root"], pair["family"]
    sd = jax_export.state_dict_from_params(family, pair["jstate"].params)
    pth = os.path.join(root, "ref.pth")
    torch.save({"step": 1234, "model_type": family, "model_state_dict": sd}, pth)
    jpath = jax_import.import_torch_checkpoint(pth, pair["jcfg"], os.path.join(root, "ji"))
    _, _, template = jax_create_train_state(pair["jcfg"], jax.random.key(0))
    jst = jax.tree.map(np.asarray, jax_load_checkpoint(jpath, template))
    ppath = torch_import.import_torch_checkpoint(pth, pair["cfg"], os.path.join(root, "pi"))
    assert read_metadata(ppath) == {"step": 1234, "model_type": family}
    pst = restore_train_state(create_train_state(pair["cfg"], device="cpu"), ppath)
    assert pst.step == int(jst.step) == 1234
    assert pst.optimizer.count == int(jst.opt_state[0].count) == 1234
    assert all(float(m.abs().max()) == 0.0 for m in pst.optimizer.mu + pst.optimizer.nu)
    for model, ref in ((pst.params, jst.params), (pst.fine_params, jst.fine_params),
                       (pst.fine_params, jst.params)):
        for a, b in zip(_flat_in_param_order(export_jax_params(model)),
                        _flat_in_param_order(ref)):
            np.testing.assert_array_equal(a, b)


def test_round_trip_is_bit_for_bit(pair):
    """Export (coarse) then import back: the coarse and the fine model equal
    the original coarse model, the step the exported one."""
    root = pair["root"]
    pth = torch_export.export_torch_checkpoint(pair["pckpt"], pair["cfg"],
                                               os.path.join(root, "rt.pth"))
    back = torch_import.import_torch_checkpoint(pth, pair["cfg"], os.path.join(root, "rt"))
    orig = load_checkpoint(pair["pckpt"])
    got = load_checkpoint(back)
    assert got["train_step"] == got["step"] == STEP
    _same(got["params"], orig["params"])
    _same(got["fine_params"], orig["params"])


def test_reference_resume_of_the_export_steps(pair, tmp_path):
    """The reference's resume: its Adam and LambdaLR load the exported dicts
    and take a step (the port's NeRF has the reference's keys; a SIREN's
    stand-in is a module of the same parameter shapes in the same order)."""
    pth = torch_export.export_torch_checkpoint(pair["pckpt"], pair["cfg"],
                                               str(tmp_path / "r.pth"))
    ck = torch.load(pth, weights_only=True)
    shapes = [v.shape for v in ck["model_state_dict"].values()]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    if pair["family"] == "nerf":
        model = NeRFModel(hidden_dim=32)
        model.load_state_dict(ck["model_state_dict"])
        params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=5e-3)
    opt.load_state_dict(ck["optimizer_state_dict"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    sched.load_state_dict(ck["scheduler_state_dict"])
    before = [p.detach().clone() for p in params]
    sum((p * p).sum() for p in params).backward()
    opt.step()
    sched.step()
    assert all(not torch.equal(a, p) for a, p in zip(before, params))
    assert opt.state_dict()["state"][0]["step"].item() == STEP + 1


@pytest.mark.parametrize("family", ["gabor", "kilonerf"])
def test_other_families_raise_as_nerf_tpu(family, tmp_path):
    """Families the reference does not have raise ValueError with nerf_tpu's
    message, on import and on export."""
    with pytest.raises(ValueError) as want:
        jax_import.params_from_state_dict(family, {})
    with pytest.raises(ValueError) as got:
        torch_import.params_from_state_dict(family, {})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_export.state_dict_from_params(family, {})
    with pytest.raises(ValueError) as got:
        torch_export.state_dict_from_params(family, None)
    assert str(got.value) == str(want.value)
    cfg = Config(model_type=family, hidden_dim=32, num_samples=8)
    ckpt = save_train_state(create_train_state(cfg, device="cpu"), str(tmp_path), family, 1)
    with pytest.raises(ValueError, match="reference families"):
        torch_export.export_torch_checkpoint(ckpt, cfg, str(tmp_path / "x.pth"))


def test_export_refuses_a_missing_fine_model(tmp_path):
    cfg = Config(model_type="nerf", hidden_dim=32, num_samples=8)
    ckpt = save_train_state(create_train_state(cfg, device="cpu"), str(tmp_path), "nerf", 1)
    with pytest.raises(ValueError, match="no fine network"):
        torch_export.export_torch_checkpoint(ckpt, cfg, str(tmp_path / "x.pth"), True)


def test_import_refuses_another_architecture(pair, tmp_path):
    """A .pth of hidden 32 into a config of hidden 64: ValueError naming
    what the config expects and what the checkpoint has."""
    pth = torch_export.export_torch_checkpoint(pair["pckpt"], pair["cfg"],
                                               str(tmp_path / "a.pth"))
    with pytest.raises(ValueError, match="config expects:.*\n.*checkpoint has:"):
        torch_import.import_torch_checkpoint(
            pth, dataclasses.replace(pair["cfg"], hidden_dim=64), str(tmp_path / "m"))


def test_mains(pair, tmp_path, capsys):
    """``python -m nerf_tpu_torch.utils.torch_export`` then ``torch_import``
    with the tools' flags."""
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text("".join(f"{k} = {v}\n" for k, v in _kw(pair["family"]).items()))
    out = str(tmp_path / "m.pth")
    torch_export.main(["--config", str(cfg_path), "--checkpoint", pair["pckpt"],
                       "--out", out, "--fine"])
    torch_import.main(["--config", str(cfg_path), "--checkpoint", out,
                       "--out", str(tmp_path / "models")])
    text = capsys.readouterr().out
    assert "Exported" in text and "Imported" in text
    back = load_checkpoint(str(tmp_path / "models" / f"{pair['family']}_model_{STEP:06d}"))
    _same(back["params"], load_checkpoint(pair["pckpt"])["fine_params"])


def test_jax_checkpoint_converter(tmp_path):
    """tools/jax_checkpoint_to_torch.py on a checkpoint of nerf_tpu's fit (3
    steps): the port's fit resumed from the converted checkpoint (with no
    step left to take) holds nerf_tpu's parameters, Adam count and moments
    and state step exactly."""
    make_synthetic_blender_scene(str(tmp_path / "scene"), h=16, w=16, num_train=2,
                                 num_val=1, num_test=1)
    text = (f"dataset_path = {tmp_path / 'scene'}\nnum_random_rays = 32\nnum_iters = 3\n"
            "num_samples = 8\nnum_fine_samples = 8\nhidden_dim = 32\nuse_pallas = false\n"
            f"log_interval = 1\nval_interval = 100\nsave_interval = 100\n"
            f"save_path = {tmp_path / 'jax_models'}\nlog_dir = {tmp_path / 'jax_logs'}\n")
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text(text)
    from nerf_tpu.config import parse_config_file as jax_parse

    jcfg = jax_parse(str(cfg_path))
    jax_fit(jcfg, enable_tensorboard=False)
    jpath = str(tmp_path / "jax_models" / "nerf_model_000003")
    jax_checkpoint_to_torch.main(["--config", str(cfg_path), "--checkpoint", jpath,
                                  "--out", str(tmp_path / "port_models")])
    ppath = str(tmp_path / "port_models" / "nerf_model_000003")
    assert read_metadata(ppath) == {"step": 3, "model_type": "nerf"}
    _, _, template = jax_create_train_state(jcfg, jax.random.key(0))
    jst = jax.tree.map(np.asarray, jax_load_checkpoint(jpath, template))
    cfg = dataclasses.replace(Config(**{k: getattr(jcfg, k) for k in (
        "dataset_path", "num_random_rays", "num_samples", "num_fine_samples",
        "hidden_dim", "log_interval", "val_interval", "save_interval")}),
        save_path=str(tmp_path / "resumed"), log_dir=str(tmp_path / "port_logs"))
    state = fit(cfg, resume_path=ppath, max_steps=3, device="cpu", log=QUIET)
    assert state.step == int(jst.step) == 3      # a final checkpoint: step and iteration agree
    assert state.optimizer.count == int(jst.opt_state[0].count) == 3
    got = (_flat_in_param_order(export_jax_params(state.params))
           + _flat_in_param_order(export_jax_params(state.fine_params)))
    want = _flat_in_param_order(jst.params) + _flat_in_param_order(jst.fine_params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    adam = jst.opt_state[0]
    for mine, theirs in ((state.optimizer.mu, adam.mu), (state.optimizer.nu, adam.nu)):
        want = _flat_in_param_order(theirs[0]) + _flat_in_param_order(theirs[1])
        assert len(mine) == len(want)
        for a, b in zip(mine, want):
            np.testing.assert_array_equal(a.numpy(), b)
