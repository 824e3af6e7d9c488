"""The port's serving surface against nerf_tpu's, plus the port's guards:
RenderService images, the HTTP routes, checkpoints, the stdlib PNG codec
against imageio, no JAX in the port, and no silent CPU fallback."""

from __future__ import annotations

import ast
import dataclasses
import glob
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from nerf_tpu.config import Config as JaxConfig
from nerf_tpu.serve import RenderService as JaxRenderService
from nerf_tpu.train.state import create_train_state
from nerf_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.models.convert import load_jax_params
from nerf_tpu_torch.models.registry import model_from_config
from nerf_tpu_torch.ops.cuda.fused_render import FusedNerfRender
from nerf_tpu_torch.serve import RenderService, build_renderer, make_http_server
from nerf_tpu_torch.train.loop import render_settings_from_config
from nerf_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    read_metadata,
    save_checkpoint,
)
from nerf_tpu_torch.utils.device import resolve_device
from nerf_tpu_torch.utils.png import decode_png, encode_png, read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(model_type="nerf", hidden_dim=32, num_samples=8,
              num_fine_samples=16, perturb=False, chunk_size=100,
              num_render_poses=4)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """The JAX service (pure-JAX path, its own Orbax checkpoint) and the
    port's services (fused and unfused) from a port checkpoint of the same
    parameters."""
    root = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_blender_scene(root, h=16, w=16, num_train=1, num_val=1,
                                 num_test=1)
    jsave = str(tmp_path_factory.mktemp("jax_models"))
    jcfg = JaxConfig(dataset_path=root, save_path=jsave, use_pallas=False,
                     **FIELDS)
    _, _, state = create_train_state(jcfg, jax.random.key(jcfg.seed))
    jckpt = jax_save_checkpoint(state, jsave, "nerf", 5)
    jsvc = JaxRenderService.from_checkpoint(jcfg, jckpt, log=lambda *a: None)

    tsave = str(tmp_path_factory.mktemp("port_models"))
    cfg = Config(dataset_path=root, save_path=tsave, **FIELDS)
    coarse, fine = model_from_config(cfg), model_from_config(cfg)
    load_jax_params(coarse, jax.tree.map(np.asarray, state.params))
    load_jax_params(fine, jax.tree.map(np.asarray, state.fine_params))
    tckpt = save_checkpoint(coarse, fine, tsave, "nerf", 5)
    quiet = dict(device="cpu", log=lambda *a: None)
    fused = RenderService.from_checkpoint(cfg, tckpt, **quiet)
    unfused = RenderService.from_checkpoint(
        dataclasses.replace(cfg, use_pallas=False), tckpt, **quiet)
    return {"jax": jsvc, "fused": fused, "unfused": unfused, "cfg": cfg,
            "ckpt": tckpt}


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("pose", [0, 3])
def test_service_image_matches_jax(services, route, pose):
    jsvc, svc = services["jax"], services[route]
    assert svc.hw == jsvc.hw == (16, 16)
    np.testing.assert_allclose(svc.focal, jsvc.focal, rtol=1e-6)
    np.testing.assert_allclose(svc.orbit_pose(pose), jsvc.orbit_pose(pose),
                               atol=1e-6)
    before = FusedNerfRender.launches
    img = svc.render_pose(svc.orbit_pose(pose), key_idx=pose)
    assert FusedNerfRender.launches == before      # CPU: never the kernel
    ref = jsvc.render_pose(jsvc.orbit_pose(pose), key_idx=pose)
    assert img.shape == (16, 16, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, ref, atol=1e-4)


def test_same_request_same_image(services):
    cfg = dataclasses.replace(services["cfg"], perturb=True)
    svc = RenderService.from_checkpoint(cfg, services["ckpt"], device="cpu",
                                        log=lambda *a: None)
    a = svc.render_pose(svc.orbit_pose(1), key_idx=1)
    b = svc.render_pose(svc.orbit_pose(1), key_idx=1)
    c = svc.render_pose(svc.orbit_pose(1), key_idx=2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_custom_resolution(services):
    svc = RenderService.from_checkpoint(services["cfg"], services["ckpt"],
                                        hw=(8, 8), device="cpu",
                                        log=lambda *a: None)
    assert svc.hw == (8, 8)
    np.testing.assert_allclose(svc.focal, services["fused"].focal * 8 / 16,
                               rtol=1e-6)
    assert svc.render_pose(svc.orbit_pose(0)).shape == (8, 8, 3)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_routes(services):
    svc = services["fused"]
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        code, ctype, body = _get(base + "/health")
        health = json.loads(body)
        assert code == 200 and ctype == "application/json"
        assert health["status"] == "ok" and health["hw"] == [16, 16]
        assert health["device"] == "cpu"

        code, ctype, body = _get(base + "/pose/0")
        assert (code, ctype) == (200, "image/png")
        np.testing.assert_array_equal(
            decode_png(body),
            (svc.render_pose(svc.orbit_pose(0)) * 255).astype(np.uint8))

        m = ",".join(str(x) for x in np.eye(4)[:3].reshape(-1))
        code, _, body = _get(base + f"/render?m={m}")
        assert code == 200 and decode_png(body).shape == (16, 16, 3)

        for bad in ("/render?m=1,2", "/render", "/pose/x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404
        assert json.loads(_get(base + "/health")[2])["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_build_renderer_bake_refuses_nerf_and_bakes_occupancy(services):
    """Baked caches are ported now for the families that bake (tests/
    test_torch_port_fastnerf.py, test_torch_port_plenoctree.py): a NeRF has
    none and raises ValueError, as nerf_tpu's build_renderer does;
    occupancy priors are ported (tests/test_torch_port_occupancy.py): the
    renderer samples from a baked grid."""
    cfg = services["cfg"]
    m = model_from_config(cfg)
    with pytest.raises(ValueError, match="bake: model 'nerf' has no baked cache"):
        build_renderer(m, None, cfg, None, bake=32)
    renderer, params = build_renderer(m, None, cfg, render_settings_from_config(cfg),
                                      occupancy=8, log=lambda *a: None)
    assert renderer.occupancy.grid.shape == (8, 8, 8, 1) and params[0] is m


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_and_metadata(tmp_path):
    cfg = Config(hidden_dim=32)
    a = model_from_config(cfg, generator=torch.Generator().manual_seed(1))
    path = save_checkpoint(a, None, str(tmp_path), "nerf", 12)
    assert os.path.basename(path) == "nerf_model_000012"
    assert read_metadata(path) == {"step": 12, "model_type": "nerf"}
    state = load_checkpoint(path)
    assert state["step"] == 12 and state["fine_params"] == {}
    b = model_from_config(cfg)
    b.load_state_dict(state["params"])
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    save_checkpoint(a, a, str(tmp_path), "nerf", 30)
    assert latest_checkpoint(str(tmp_path)) == os.path.join(
        str(tmp_path), "nerf_model_000030")
    assert latest_checkpoint(str(tmp_path), "siren") is None


def test_orphaned_metadata_is_refused(tmp_path):
    path = tmp_path / "nerf_model_000007"
    (tmp_path / "nerf_model_000007.meta.json").write_text(
        json.dumps({"step": 7, "model_type": "nerf"}))
    with pytest.raises(FileNotFoundError, match="orphaned"):
        read_metadata(str(path))


# ---------------------------------------------------------------- PNG codec


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:23, 0:31]
    smooth = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
    return {
        "rgb": rng.integers(0, 256, (23, 31, 3), dtype=np.uint8),
        "rgba": np.dstack([smooth, smooth[::-1], 255 - smooth,
                           rng.integers(0, 256, (23, 31), dtype=np.uint8)]),
        "gray": smooth,
        "gray_alpha": np.dstack([smooth, 255 - smooth]),
    }


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray_alpha"])
def test_png_round_trips_against_imageio(tmp_path, kind):
    img = _images()[kind]
    p = str(tmp_path / "a.png")
    write_png(p, img)
    np.testing.assert_array_equal(imageio.imread(p), img)
    q = str(tmp_path / "b.png")
    imageio.imwrite(q, img)
    np.testing.assert_array_equal(read_png(q), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filters(img):
    """An RGB PNG whose rows cycle through filter types 0-4."""
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        f = y % 5
        out = []
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][f]
            out.append((cur[x] - pred) % 256)
        rows.append(bytes([f]) + bytes(out))
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_undoes_every_filter():
    img = _images()["rgb"]
    buf = _png_with_filters(img)
    np.testing.assert_array_equal(decode_png(buf), img)
    np.testing.assert_array_equal(imageio.imread(buf, format="png"), img)
    assert encode_png(img)[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError):
        decode_png(b"not a png at all")


# ---------------------------------------------------------------- guards


def _port_sources():
    files = glob.glob(os.path.join(REPO, "nerf_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_sources()
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_guard_catches_what_it_should():
    assert _forbidden("jax.numpy") and _forbidden("nerf_tpu.serve")
    assert _forbidden("nerf_tpu") and not _forbidden("nerf_tpu_torch.serve")


def test_cuda_without_a_card_raises(services):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderService.from_checkpoint(services["cfg"], services["ckpt"],
                                      log=lambda *a: None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (str(alone), "chip_smoke.py")):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
