"""The port's parallel layer (``nerf_tpu_torch.parallel``, the distributed
branch of ``fit``, ``train/multiscene_loop.py``, ``cli/multiscene_cli.py``
and the eval render's device split) against nerf_tpu's on the CPU.

The mesh and the pool shards against ``nerf_tpu.parallel.mesh``; the
multi-scene step on injected batches against nerf_tpu's
``make_multiscene_train_step``; ``fit_multiscene``'s chunks, resume,
metadata and refusals; and a two-rank gloo block (spawned once for the
module, ``tests/torch_parallel_worker.py``) against one process: ``fit`` on
``data:2``, a validation image split over the ranks, ``fit_multiscene`` on
``scene:2,data:1`` and ``scene:1,data:2``."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from tensorboard.backend.event_processing import event_accumulator

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.data import pipeline as jpipe
from nerf_tpu.models import NeRFModel as JaxNeRF
from nerf_tpu.parallel.mesh import create_mesh as jax_create_mesh
from nerf_tpu.parallel.mesh import shard_pool as jax_shard_pool
from nerf_tpu.parallel.multiscene import make_multiscene_train_step as jax_ms_step
from nerf_tpu.parallel.multiscene import stack_scenes as jax_stack
from nerf_tpu.render.renderer import RenderSettings as JaxSettings
from nerf_tpu.train.multiscene_loop import fit_multiscene as jax_fit_multiscene
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from nerf_tpu.train.state import TrainState as JaxTrainState
from tests import torch_parallel_worker as worker
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.cli import multiscene_cli
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.data.pipeline import RayBatch, RayPool
from nerf_tpu_torch.models.convert import _flat_in_param_order, export_jax_params, load_jax_params
from nerf_tpu_torch.parallel.mesh import create_mesh, shard_pool
from nerf_tpu_torch.parallel.multiscene import (
    _make_multiscene_body,
    make_multiscene_train_step,
    scene_seed,
    stack_scenes,
)
from nerf_tpu_torch.render.renderer import RenderSettings
from nerf_tpu_torch.train.loop import fit, render_settings_from_config
from nerf_tpu_torch.train.multiscene_loop import fit_multiscene
from nerf_tpu_torch.train.state import create_train_state
from nerf_tpu_torch.train import step as step_module
from nerf_tpu_torch.train.step import _Replicas, make_eval_render, make_train_step
from nerf_tpu_torch.utils.checkpoint import load_checkpoint, read_metadata

QUIET = lambda *a: None  # noqa: E731
NEAR, FAR = 2.0, 6.0


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` (2-norms over the tensor)."""
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("spec", ["", "data:8", "scene:2,data:4", "scene:4,data:2"])
def test_create_mesh_matches_nerf_tpu(spec):
    """Names, sizes and each rank's coordinates: rank r sits where nerf_tpu
    puts device r of its 8 (the test process's virtual CPU devices)."""
    ref = jax_create_mesh(spec)
    devices = jax.devices()
    for r in range(8):
        mesh = create_mesh(spec, world_size=8, rank=r)
        assert mesh.axis_names == tuple(ref.axis_names)
        assert mesh.shape == dict(ref.shape)
        where = np.argwhere(ref.devices == devices[r])[0]
        assert mesh.coords == dict(zip(ref.axis_names, map(int, where)))
        assert mesh.groups == {}


@pytest.mark.parametrize("spec", ["data:4", "scene:3,data:2"])
def test_create_mesh_refuses_as_nerf_tpu(spec):
    with pytest.raises(ValueError) as want:
        jax_create_mesh(spec)
    with pytest.raises(ValueError) as got:
        create_mesh(spec, world_size=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_shard_pool_matches_nerf_tpu(shards):
    """37 rays wrap-padded to a multiple of the shards: rank r's shard is
    nerf_tpu's shard on device r."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(37, 3)).astype(np.float32) for _ in range(4)]
    ref = jax_shard_pool(jpipe.RayPool(*map(jnp.asarray, arrays)),
                         jax_create_mesh(f"data:{shards}", jax.devices()[:shards]))
    pool = RayPool(*map(torch.from_numpy, arrays))
    for r in range(shards):
        got = shard_pool(pool, create_mesh(f"data:{shards}", world_size=shards, rank=r))
        for g, w in zip(got, ref):
            shard = next(s for s in w.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(g.numpy(), np.asarray(shard.data))


# ---------------------------------------------------------------- multi-scene step


def test_multiscene_step_matches_nerf_tpu(monkeypatch):
    """Three steps of S = 2 NeRFs (hidden 32, 8 + 16 samples, perturb off) on
    injected batches: nerf_tpu's make_multiscene_train_step (its pure path,
    with RayPool.sample giving a pool's first n rays and each pool exactly
    the batch) against the port's on the same batches. Per-scene loss and
    mse within 1e-5 relative; the parameters within the bounds of
    test_torch_port_train.py::test_hierarchical_train_step_matches_jax
    (6 lr each, the mean under 0.1 lr)."""
    monkeypatch.setattr(jpipe.RayPool, "sample",
                        lambda self, key, n: jpipe.RayBatch(*(x[:n] for x in self)))
    s, b = 2, 16
    kw = dict(near=NEAR, far=FAR, num_samples=8, num_fine_samples=16, perturb=False,
              white_background=True)
    jm = JaxNeRF(hidden_dim=32)
    inits = [(jm.init(jax.random.key(2 * i)), jm.init(jax.random.key(2 * i + 1)))
             for i in range(s)]
    params = jax_stack([p for p, _ in inits])
    fine = jax_stack([f for _, f in inits])
    tx = jax_make_optimizer(JaxConfig())
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, fine_params=fine,
                           opt_state=tx.init((params, fine)))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(s):
        ro = (rng.uniform(-0.5, 0.5, (b, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
        rd = rng.normal(size=(b, 3)) * 0.2 + [0.0, 0.0, -1.0]
        rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
        batches.append((ro, rd, rng.uniform(0, 1, (b, 3)).astype(np.float32), rd))
    pools = jpipe.RayPool(*(jnp.asarray(np.stack(x)) for x in zip(*batches)))
    step_j = jax_ms_step(jm, tx, JaxSettings(**kw), b, jax.random.key(0),
                         jax_create_mesh("scene:1,data:1", jax.devices()[:1]),
                         use_pallas=False, donate=False)

    cfg = Config(hidden_dim=32, **kw)
    states = [create_train_state(cfg, device="cpu") for _ in range(s)]
    for st, (p, f) in zip(states, inits):
        load_jax_params(st.params, jax.tree.map(np.asarray, p))
        load_jax_params(st.fine_params, jax.tree.map(np.asarray, f))
    _, train_on_batches = _make_multiscene_body(
        [st.params for st in states], RenderSettings(**kw), b, 0, create_mesh("scene:1"))
    tbatches = [RayBatch(*map(torch.from_numpy, x)) for x in batches]
    for _ in range(3):
        jstate, mj = step_j(jstate, pools)
        m = train_on_batches(states, tbatches)
        for k in ("loss", "mse"):
            assert m[k].shape == (s,)
            np.testing.assert_allclose(m[k].numpy(), np.asarray(mj[k]), rtol=1e-5)
    lr = 5e-4
    for i, st in enumerate(states):
        assert st.step == 3 and st.optimizer.count == 3
        for model, ref in ((st.params, jstate.params), (st.fine_params, jstate.fine_params)):
            ref = jax.tree.map(lambda x: np.asarray(x[i]), ref)
            for a, w in zip(_flat_in_param_order(export_jax_params(model)),
                            _flat_in_param_order(ref)):
                np.testing.assert_allclose(a, w, rtol=0, atol=6 * lr)
                assert np.abs(a - w).mean() < 0.1 * lr


def _small_cfg(**kw) -> Config:
    return Config(hidden_dim=32, num_samples=8, num_fine_samples=8, near=NEAR, far=FAR,
                  learning_rate=5e-3, **kw)


def _pool(seed: int, m: int = 200) -> RayPool:
    rng = np.random.default_rng(seed)
    ro = (rng.uniform(-0.5, 0.5, (m, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.normal(size=(m, 3)) * 0.2 + [0.0, 0.0, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return RayPool(*map(torch.from_numpy, (ro, rd, rng.uniform(0, 1, (m, 3)).astype(
        np.float32), rd)))


def test_multiscene_chunk_equals_single_steps():
    """A chunk of 3 steps equals 3 single steps bit for bit (perturbed
    samples), and each scene equals its own one-scene step seeded with
    scene_seed."""
    cfg = _small_cfg()
    settings = render_settings_from_config(cfg)
    pools = [_pool(0), _pool(1)]
    runs = []
    for chunk in (3, 1, None):
        states = [create_train_state(cfg, seed=scene_seed(0, i), device="cpu") for i in range(2)]
        if chunk is None:
            for i, st in enumerate(states):
                step = make_train_step(st.params, settings, 32, scene_seed(0, i))
                for _ in range(3):
                    step(st, pools[i])
        else:
            step = make_multiscene_train_step([st.params for st in states], settings, 32, 0,
                                              create_mesh(), num_steps=chunk)
            for _ in range(3 // chunk):
                m = step(states, pools)
            assert m["mse"].shape == ((3, 2) if chunk == 3 else (2,))
        runs.append(states)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for x, y in zip(a.params.parameters(), b.params.parameters()):
                assert torch.equal(x, y)
            for x, y in zip(a.optimizer.nu, b.optimizer.nu):
                assert torch.equal(x, y)


def test_stack_scenes():
    pools = [_pool(0, 5), _pool(1, 5)]
    got = stack_scenes(pools)
    assert isinstance(got, RayPool) and got.rays_o.shape == (2, 5, 3)
    assert torch.equal(got.rgb[1], pools[1].rgb)
    assert stack_scenes([{"a": [torch.ones(2)]}] * 3)["a"][0].shape == (3, 2)


# ---------------------------------------------------------------- fit_multiscene


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    for name, n in (("scene_a", 4), ("scene_b", 3)):
        make_synthetic_blender_scene(os.path.join(root, name), h=16, w=16, num_train=n,
                                     num_val=1, num_test=1)
    make_synthetic_blender_scene(os.path.join(root, "scene_c"), h=8, w=8, num_train=2,
                                 num_val=1, num_test=1)
    return root


def _ms_cfg(root: str, tag: str, **kw) -> Config:
    return dataclasses.replace(worker.fit_config(root, tag), num_iters=4, **kw)


def _scalars(log_dir: str) -> dict:
    (run,) = os.listdir(log_dir)
    out: dict = {}
    with open(os.path.join(log_dir, run, "train.log")) as f:
        for line in f:
            if line.startswith("scalar "):
                _, tag, step, value = line.split()
                out.setdefault(tag, {})[int(step)] = float(value)
    return out


@pytest.fixture(scope="module")
def one_process(root):
    """The one-process runs the two-rank runs are held against: fit (3
    steps) with its validation image, and fit_multiscene (S = 2, 4 steps,
    through the CLI). One intra-op thread, as each rank runs: the CPU's
    products sum in another order on more threads."""
    with _one_thread():
        return _one_process(root)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class _SecondHalf(Exception):
    """Raised by the second half's reduce hook: that half takes no update."""


def _halves_scan_step(model, settings, batch_size, seed, num_steps, **kw):
    """``make_scan_train_step`` of one process that sums its gradient as
    ``data:2``'s two ranks do: each step renders the global batch's two
    halves one after the other (``shard`` (0, 2), then (1, 2), on the same
    draws), and the update takes (g0 + g1) / 2 and the mean of the two
    halves' losses, the ``all_reduce`` sum of ``parallel/dp.py::
    average_grads`` divided by 2. A one-batch gradient sums the rows in
    another order, and the fine model's first skip layer carries gradients
    of 1e-9 to 3e-8, at Adam's eps (1e-8), where its update g / (|g| + eps)
    turns that rounding into parameter gaps of up to 2.5e-5 in 3 steps."""
    kw = {k: v for k, v in kw.items() if k not in ("shard", "reduce")}
    second = {}

    def grads(state):
        return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                for m in state.models() for p in m.parameters()]

    def reduce1(state, loss, mse):
        second.update(grads=grads(state), loss=loss, mse=mse)
        raise _SecondHalf

    sample1, train1 = step_module._make_step_body(model, settings, batch_size, seed,
                                                  shard=(1, 2), reduce=reduce1, **kw)

    def reduce0(state, loss, mse):
        first = grads(state)
        with contextlib.suppress(_SecondHalf):
            train1(state, sample1(state, second["pool"]), second["occ"])
        params = [p for m in state.models() for p in m.parameters()]
        for p, a, b in zip(params, first, second["grads"]):
            p.grad = (a + b) / 2
        return (loss + second["loss"]) / 2, (mse + second["mse"]) / 2

    sample0, train0 = step_module._make_step_body(model, settings, batch_size, seed,
                                                  shard=(0, 2), reduce=reduce0, **kw)

    def step_n(state, pool, occ_grid=None):
        second.update(pool=pool, occ=occ_grid)
        ms = [train0(state, sample0(state, pool), occ_grid) for _ in range(num_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return step_n


def _one_process(root: str) -> dict:
    cfg = worker.fit_config(root, "one")
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(step_module, "make_scan_train_step", _halves_scan_step)
        state = fit(cfg, device="cpu", log=QUIET)
    out = {"cfg": cfg, "state": state,
           "val": worker.val_image(state, cfg, worker.val_rays(root))}
    ms = _ms_cfg(root, "one_ms")
    text = "".join(f"{f.name} = {getattr(ms, f.name)}\n" for f in dataclasses.fields(ms)
                   if f.name in ("num_random_rays", "num_samples", "num_fine_samples",
                                 "hidden_dim", "learning_rate", "num_iters", "log_interval",
                                 "val_interval", "save_interval", "chunk_size", "save_path",
                                 "log_dir"))
    path = os.path.join(root, "ms.txt")
    with open(path, "w") as f:
        f.write(text)
    multiscene_cli.main(["--config", path, "--scenes", *worker.scenes(root),
                         "--device", "cpu"], log=QUIET)
    out["ms"] = ms
    return out


def _ms_ckpt(cfg: Config, step: int) -> str:
    return os.path.join(cfg.save_path, f"nerf_multiscene_model_{step:06d}")


def test_fit_multiscene_runs_and_resumes(root, one_process):
    """Four steps over two scenes (pools of 1024 and 768 rays, trimmed to
    768): per-scene mse scalars every step, validation at 2, the interval
    and final stacked checkpoints. A resume from the step-2 checkpoint
    restarts at iteration 2 with state.step one ahead (3), as nerf_tpu's
    loop does, so its run to 3 ends on the first run's final states bit for
    bit. The event file holds each scene's validation image."""
    ms = one_process["ms"]
    scal = _scalars(ms.log_dir)
    assert sorted(scal["scene0/mse"]) == sorted(scal["scene1/mse"]) == [0, 1, 2, 3]
    assert all(np.isfinite(list(scal["loss"].values())))
    assert sorted(scal["scene0/val_psnr"]) == sorted(scal["val/psnr"]) == [2]
    np.testing.assert_allclose(scal["val/psnr"][2], np.mean(
        [scal["scene0/val_psnr"][2], scal["scene1/val_psnr"][2]]))
    (run,) = os.listdir(ms.log_dir)
    acc = event_accumulator.EventAccumulator(os.path.join(ms.log_dir, run),
                                             size_guidance={event_accumulator.IMAGES: 0})
    acc.Reload()
    for i in range(2):          # nerf_tpu's per-scene image events
        assert [(e.step, e.height, e.width) for e in acc.Images(f"scene{i}/val_render")] == [
            (2, 16, 16)]
    final = load_checkpoint(_ms_ckpt(ms, 4))
    assert final["num_scenes"] == 2 and final["train_step"] == 4
    assert all(v.shape[0] == 2 for v in final["params"].values())
    assert all(m.shape[0] == 2 for m in final["optimizer"]["mu"])
    res = dataclasses.replace(ms, save_path=os.path.join(root, "res_ms", "m"),
                              log_dir=os.path.join(root, "res_ms", "l"))
    with _one_thread():
        fit_multiscene(res, worker.scenes(root), resume_path=_ms_ckpt(ms, 2), max_steps=3,
                       device="cpu", log=QUIET)
    got = load_checkpoint(_ms_ckpt(res, 3))
    assert got["train_step"] == 4
    for key in ("params", "fine_params"):
        for k, v in final[key].items():
            assert torch.equal(got[key][k], v)
    for a, b in zip(got["optimizer"]["nu"], final["optimizer"]["nu"]):
        assert torch.equal(a, b)


def test_fit_multiscene_metadata_and_refusals_match_nerf_tpu(root, one_process, tmp_path):
    """The sidecar's keys and values and the refusals (another number of
    scenes on resume, scenes of two resolutions) equal nerf_tpu's."""
    jcfg = JaxConfig(num_random_rays=64, num_samples=8, hidden_dim=32, num_iters=1,
                     log_interval=1, val_interval=100, save_interval=100,
                     use_pallas=False, save_path=str(tmp_path / "jax"),
                     log_dir=str(tmp_path / "jax_logs"))
    jax_fit_multiscene(jcfg, worker.scenes(root), max_steps=1, enable_tensorboard=False)
    with open(str(tmp_path / "jax" / "nerf_multiscene_model_000001.meta.json")) as f:
        want = json.load(f)
    got = read_metadata(_ms_ckpt(one_process["ms"], 4))
    assert got == dict(want, step=4)
    assert got["scenes"] == ["scene_a", "scene_b"] and got["base_model_type"] == "nerf"
    three = worker.scenes(root) + [os.path.join(root, "scene_a")]
    with pytest.raises(ValueError) as jerr:
        jax_fit_multiscene(jcfg, three, resume_path=str(
            tmp_path / "jax" / "nerf_multiscene_model_000001"), enable_tensorboard=False)
    with pytest.raises(ValueError) as err:
        fit_multiscene(one_process["ms"], three, resume_path=_ms_ckpt(one_process["ms"], 4),
                       device="cpu", log=QUIET)
    assert str(err.value) == str(jerr.value)
    mixed = [os.path.join(root, "scene_a"), os.path.join(root, "scene_c")]
    with pytest.raises(ValueError) as jerr:
        jax_fit_multiscene(jcfg, mixed, enable_tensorboard=False)
    with pytest.raises(ValueError) as err:
        fit_multiscene(one_process["ms"], mixed, device="cpu", log=QUIET)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------- eval split


def test_eval_split_over_devices_equals_one_device(root, one_process):
    """make_eval_render with devices = [cpu, cpu] (tiles 0 and 2 on the
    first, 1 on a replica) gives the one-device image bit for bit, every
    output, with perturbed hierarchical samples."""
    cfg, state = one_process["cfg"], one_process["state"]
    settings = render_settings_from_config(cfg)
    rays = worker.val_rays(root)
    outs = []
    for devices in (None, ["cpu", "cpu"]):
        render = make_eval_render(state.params, settings, devices=devices)
        with _one_thread():
            outs.append(render(state.params, state.fine_params, *rays,
                               torch.Generator().manual_seed(5)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(outs[0].rgb, one_process["val"])


def test_split_render_copies_a_model_once_until_it_changes():
    """The split render's replicas: a model on its own device is itself; a
    model on another is copied once and that copy reused while the model is
    the same object with the same tensors; an in-place write or another
    model makes a new copy; a model of buffers only (the baked FastNeRF
    cache) is copied as well."""
    meta, cpu = torch.device("meta"), torch.device("cpu")
    replicas = _Replicas()
    model = torch.nn.Linear(3, 2)
    assert replicas.get(model, cpu, "coarse") is model
    assert replicas.get(None, meta, "fine") is None
    first = replicas.get(model, meta, "coarse")
    assert first is not model and first.weight.device == meta
    assert replicas.get(model, meta, "coarse") is first
    with torch.no_grad():
        model.weight.add_(1.0)
    second = replicas.get(model, meta, "coarse")
    assert second is not first
    assert replicas.get(model, meta, "coarse") is second
    other = torch.nn.Linear(3, 2)
    assert replicas.get(other, meta, "coarse") is not second
    buffers = torch.nn.Module()
    buffers.register_buffer("grid", torch.zeros(4))
    copied = replicas.get(buffers, meta, "fine")
    assert copied.grid.device == meta and replicas.get(buffers, meta, "fine") is copied


# ---------------------------------------------------------------- two ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(root, one_process):
    """Two gloo ranks on the CPU, spawned once: their results by rank."""
    mp.start_processes(worker.run, args=(root, _free_port()), nprocs=2, join=True,
                       start_method="spawn")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
            for r in range(2)]


def test_fit_data2_matches_one_process(root, one_process, two_ranks):
    """fit on data:2 against one process, 3 steps: the logged losses and
    every parameter within 1e-6 relative (norms); both ranks identical. The
    one process sums the two halves' gradients as the ranks do
    (``_halves_scan_step``): the test holds the collective and the shards,
    not the host's row order of a 64-ray gradient."""
    state = one_process["state"]
    for key, model in (("params", state.params), ("fine_params", state.fine_params)):
        for k, v in model.state_dict().items():
            assert torch.equal(two_ranks[0][key][k], two_ranks[1][key][k])
            assert _rel(two_ranks[0][key][k], v) <= 1e-6, k
    want = _scalars(one_process["cfg"].log_dir)["loss"]
    got = _scalars(os.path.join(root, "rank0", "logs"))["loss"]
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6)


def test_validation_split_over_ranks_equals_one_process(root, one_process, two_ranks):
    """The validation image with its tiles split over two ranks equals the
    one-process image of the same parameters bit for bit; so does fit's
    validation PNG at step 2 (its parameters within rounding)."""
    from nerf_tpu_torch.utils.png import read_png

    state = create_train_state(one_process["cfg"], device="cpu")
    for key, model in (("params", state.params), ("fine_params", state.fine_params)):
        model.load_state_dict(two_ranks[0][key])
    with _one_thread():
        ref = worker.val_image(state, one_process["cfg"], worker.val_rays(root))
    assert torch.equal(two_ranks[0]["val"], ref) and torch.equal(two_ranks[1]["val"], ref)
    logs = [os.path.join(d, os.listdir(d)[0]) for d in (
        os.path.join(root, "rank0", "logs"), one_process["cfg"].log_dir)]
    pngs = [read_png(os.path.join(d, "val_0000002.png")).astype(int) for d in logs]
    assert np.abs(pngs[0] - pngs[1]).max() <= 1


def test_multiscene_scene2_is_one_process_bit_for_bit(root, one_process, two_ranks):
    """scene:2,data:1 (each rank one scene): every scene's state equals the
    one-process S = 2 run's bit for bit, at the interval and final saves."""
    for step in (2, 4):
        want = load_checkpoint(_ms_ckpt(one_process["ms"], step))
        got = load_checkpoint(_ms_ckpt(_ms_cfg(root, "rank0/scene2_data1"), step))
        for key in ("params", "fine_params"):
            for k, v in want[key].items():
                assert torch.equal(got[key][k], v), k
        for a, b in zip(got["optimizer"]["mu"] + got["optimizer"]["nu"],
                        want["optimizer"]["mu"] + want["optimizer"]["nu"]):
            assert torch.equal(a, b)


def test_multiscene_data2_matches_one_process(root, one_process, two_ranks):
    """scene:1,data:2 (each scene's batch split over the ranks): every
    scene's parameters within 1e-6 relative of the one-process run."""
    want = load_checkpoint(_ms_ckpt(one_process["ms"], 4))
    got = load_checkpoint(_ms_ckpt(_ms_cfg(root, "rank0/scene1_data2"), 4))
    for key in ("params", "fine_params"):
        for k, v in want[key].items():
            for i in range(2):
                assert _rel(got[key][k][i], v[i]) <= 1e-6, (k, i)


def test_dp_step_is_the_step_of_both_ranks_batches(root, two_ranks):
    """make_dp_train_step over data:2 (each rank 32 rays from its own shard,
    drawn with its rank's seed; samples at the bins' midpoints): both ranks
    end equal, and equal within 1e-6 relative to one process stepping on
    the two ranks' batches together (the same rays, one sum in another
    grouping); the averaged loss within 1e-6 of the one-process loss."""
    from nerf_tpu_torch.parallel.mesh import create_mesh, shard_pool
    from nerf_tpu_torch.train.step import RANK, _make_step_body, sub_seed

    for k in two_ranks[0]["dp"]["params"]:
        assert torch.equal(two_ranks[0]["dp"]["params"][k], two_ranks[1]["dp"]["params"][k])
    cfg = worker.dp_config()
    settings = render_settings_from_config(cfg)
    state = create_train_state(cfg, device="cpu")
    pool = worker.dp_pool(root)
    samplers = [_make_step_body(state.params, settings, 32, sub_seed(cfg.seed, RANK, r))[0]
                for r in range(2)]
    shards = [shard_pool(pool, create_mesh("data:2", world_size=2, rank=r)) for r in range(2)]
    _, train_on_batch = _make_step_body(state.params, settings, 64, 0)
    with _one_thread():
        for i in range(2):
            batches = [s(state, shard) for s, shard in zip(samplers, shards)]
            m = train_on_batch(state, RayBatch(*(torch.cat(x) for x in zip(*batches))))
            np.testing.assert_allclose(float(two_ranks[0]["dp"]["loss"][i]), float(m["loss"]),
                                       rtol=1e-6)
    for k, v in state.params.state_dict().items():
        assert _rel(two_ranks[0]["dp"]["params"][k], v) <= 1e-6, k


def test_dp_step_refuses_an_indivisible_batch_as_nerf_tpu():
    from nerf_tpu.parallel.dp import make_dp_train_step as jax_dp_step

    from nerf_tpu_torch.parallel.dp import make_dp_train_step

    with pytest.raises(ValueError) as want:
        jax_dp_step(JaxNeRF(hidden_dim=32), jax_make_optimizer(JaxConfig()), JaxSettings(),
                    63, jax.random.key(0), jax_create_mesh("data:2", jax.devices()[:2]),
                    use_pallas=False)
    cfg = worker.dp_config()
    with pytest.raises(ValueError) as got:
        make_dp_train_step(create_train_state(cfg, device="cpu").params,
                           render_settings_from_config(cfg), 63, 0,
                           create_mesh("data:2", world_size=2))
    assert str(got.value) == str(want.value)


def test_multihost_without_a_cluster_is_one_process_as_nerf_tpu(monkeypatch):
    """Without torchrun's environment init_distributed starts nothing (as
    nerf_tpu's without a detected cluster) and the process is the primary;
    the backend follows the device."""
    from nerf_tpu.parallel.multihost import is_primary as jax_is_primary

    from nerf_tpu_torch.parallel import multihost

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    multihost.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and jax_is_primary()
    assert (multihost.rank(), multihost.world_size()) == (0, 1)
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"


def test_only_rank_zero_writes(root, two_ranks):
    """Rank 1 wrote no checkpoint and no log: its directories do not exist."""
    assert os.path.isdir(os.path.join(root, "rank0", "models"))
    assert sorted(os.listdir(os.path.join(root, "rank0"))) == [
        "logs", "models", "scene1_data2", "scene2_data1"]
    assert not os.path.exists(os.path.join(root, "rank1"))
