"""The port's TensorBoard event files (``nerf_tpu_torch/utils/events.py``
and ``utils/logging.py::MetricLogger``) against nerf_tpu's logger, which
writes through ``torch.utils.tensorboard.SummaryWriter``, on the CPU.

The checksum against tensorboard's, the field numbers against
``tensorboard.compat.proto``, each record's bytes against the protobuf
library's serialisation of the same message, one sequence of logger calls
through both packages read back with tensorboard's ``EventAccumulator``, and
a port ``fit`` whose events hold its ``train.log`` scalars."""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing import event_accumulator
from tensorboard.compat.proto import event_pb2, summary_pb2, tensor_pb2, tensor_shape_pb2
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c as tb_masked_crc

from nerf_tpu.utils.logging import MetricLogger as JaxMetricLogger
from tests.synthetic import make_synthetic_blender_scene

from tests.torch_port_threads import one_intra_op_thread  # noqa: F401
from nerf_tpu_torch.config import Config
from nerf_tpu_torch.train.loop import fit
from nerf_tpu_torch.utils import events
from nerf_tpu_torch.utils.logging import MetricLogger
from nerf_tpu_torch.utils.png import encode_png


def test_crc32c_check_value():
    assert events.crc32c(b"123456789") == 0xE3069283
    assert events.crc32c(b"") == 0


def test_masked_crc32c_matches_tensorboard():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 64, 1000, 4099):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert events.masked_crc32c(buf) == tb_masked_crc(buf), n


Value = summary_pb2.Summary.Value
Shape = tensor_shape_pb2.TensorShapeProto


@pytest.mark.parametrize("message, field, number", [
    (event_pb2.Event, "wall_time", events._EVENT_WALL_TIME),
    (event_pb2.Event, "step", events._EVENT_STEP),
    (event_pb2.Event, "file_version", events._EVENT_FILE_VERSION),
    (event_pb2.Event, "summary", events._EVENT_SUMMARY),
    (summary_pb2.Summary, "value", events._SUMMARY_VALUE),
    (Value, "tag", events._VALUE_TAG),
    (Value, "simple_value", events._VALUE_SIMPLE),
    (Value, "image", events._VALUE_IMAGE),
    (Value, "tensor", events._VALUE_TENSOR),
    (Value, "metadata", events._VALUE_METADATA),
    (summary_pb2.Summary.Image, "height", events._IMAGE_HEIGHT),
    (summary_pb2.Summary.Image, "width", events._IMAGE_WIDTH),
    (summary_pb2.Summary.Image, "colorspace", events._IMAGE_COLORSPACE),
    (summary_pb2.Summary.Image, "encoded_image_string", events._IMAGE_ENCODED),
    (summary_pb2.SummaryMetadata, "plugin_data", events._METADATA_PLUGIN_DATA),
    (summary_pb2.SummaryMetadata.PluginData, "plugin_name", events._PLUGIN_NAME),
    (summary_pb2.SummaryMetadata.PluginData, "content", events._PLUGIN_CONTENT),
    (tensor_pb2.TensorProto, "dtype", events._TENSOR_DTYPE),
    (tensor_pb2.TensorProto, "tensor_shape", events._TENSOR_SHAPE),
    (tensor_pb2.TensorProto, "string_val", events._TENSOR_STRING_VAL),
    (Shape, "dim", events._SHAPE_DIM),
    (Shape.Dim, "size", events._DIM_SIZE),
])
def test_field_numbers_match_tensorboard_protos(message, field, number):
    assert message.DESCRIPTOR.fields_by_name[field].number == number
    assert events.DT_STRING == tensor_pb2.TensorProto().DESCRIPTOR.fields_by_name[
        "dtype"].enum_type.values_by_name["DT_STRING"].number


def _records(path: str) -> list:
    """Every record's data, both CRCs checked with tensorboard's."""
    with open(path, "rb") as f:
        buf = f.read()
    out, pos = [], 0
    while pos < len(buf):
        header = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        data = buf[pos + 12:pos + 12 + n]
        (dcrc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        assert hcrc == tb_masked_crc(header) and dcrc == tb_masked_crc(data)
        out.append(data)
        pos += 16 + n
    return out


def test_records_are_protobufs_serialisation(tmp_path):
    """Each record holds the bytes that protobuf itself gives for the same
    Event (the wall time taken from the record)."""
    w = events.EventWriter(str(tmp_path))
    w.add_scalar("loss", 0.1234, 7)
    w.add_scalar("zero", 0.0, 0)
    w.add_text("config", "a = 1\nb = two", 0)
    img = np.random.default_rng(1).uniform(-0.2, 1.2, (3, 5, 4)).astype(np.float32)
    w.add_image("val/render", img, 300)
    w.close()
    (name,) = os.listdir(tmp_path)
    assert name.startswith("events.out.tfevents.") and w.path.endswith(name)
    recs = _records(w.path)
    got = [event_pb2.Event.FromString(r) for r in recs]
    assert got[0].file_version == "brain.Event:2" and got[0].step == 0

    hwc = (img.transpose(1, 2, 0) * 255.0).clip(0, 255).astype(np.uint8)
    plugin = summary_pb2.SummaryMetadata.PluginData(plugin_name="text", content=b"")
    want = [
        event_pb2.Event(file_version="brain.Event:2"),
        event_pb2.Event(step=7, summary=summary_pb2.Summary(value=[
            Value(tag="loss", simple_value=0.1234)])),
        event_pb2.Event(step=0, summary=summary_pb2.Summary(value=[
            Value(tag="zero", simple_value=0.0)])),
        event_pb2.Event(summary=summary_pb2.Summary(value=[Value(
            tag="config/text_summary",
            metadata=summary_pb2.SummaryMetadata(plugin_data=plugin),
            tensor=tensor_pb2.TensorProto(dtype="DT_STRING", string_val=[b"a = 1\nb = two"],
                                          tensor_shape=Shape(dim=[Shape.Dim(size=1)])))])),
        event_pb2.Event(step=300, summary=summary_pb2.Summary(value=[Value(
            tag="val/render", image=summary_pb2.Summary.Image(
                height=5, width=4, colorspace=3, encoded_image_string=encode_png(hwc)))])),
    ]
    assert len(recs) == len(want)
    for rec, ev, ref in zip(recs, got, want):
        ref.wall_time = ev.wall_time
        assert rec == ref.SerializeToString()


def _accumulate(log_dir: str):
    (run,) = os.listdir(log_dir)
    acc = event_accumulator.EventAccumulator(
        os.path.join(log_dir, run), size_guidance={k: 0 for k in (
            event_accumulator.SCALARS, event_accumulator.IMAGES,
            event_accumulator.TENSORS, event_accumulator.HISTOGRAMS,
            event_accumulator.AUDIO, event_accumulator.COMPRESSED_HISTOGRAMS)})
    acc.Reload()
    return acc


def _pixels(encoded: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(encoded)))


def test_logger_events_match_nerf_tpu(tmp_path):
    """The same calls through nerf_tpu's MetricLogger (torch's
    SummaryWriter) and the port's: equal tags, steps, float32 scalars,
    image sizes and pixels, and text."""
    rng = np.random.default_rng(3)
    val = rng.uniform(-0.1, 1.1, (24, 32, 3)).astype(np.float32)
    extra = rng.uniform(0.0, 1.0, (24, 32, 3)).astype(np.float32)
    text = "dataset_path = ./scene\nnum_iters = 3\n"
    dirs = {}
    for name, cls, kw in (("jax", JaxMetricLogger, {"quiet": False}),
                          ("port", MetricLogger, {"echo": lambda *_: None})):
        dirs[name] = str(tmp_path / name)
        lg = cls(log_dir=dirs[name], model_type="nerf", dataset_name="scene",
                 config_text=text, **kw)
        for step, mse in ((0, 0.25), (1, 0.125), (2, 0.0123456789)):
            lg.log_train(step, 5e-4 * 0.9 ** step, mse)
        lg.log_scalar("rays_per_sec", 123456.789, 2)
        lg.log_validation(2, 17.25, val)
        lg.log_image("scene1/val_render", extra, 2)
        lg.close()
    jax_acc, port_acc = _accumulate(dirs["jax"]), _accumulate(dirs["port"])
    tags = jax_acc.Tags()
    assert sorted(tags["scalars"]) == sorted(port_acc.Tags()["scalars"]) == sorted(
        ["loss", "psnr", "learning_rate", "rays_per_sec", "val/psnr"])
    for tag in tags["scalars"]:
        a, b = jax_acc.Scalars(tag), port_acc.Scalars(tag)
        assert [(e.step, e.value) for e in a] == [(e.step, e.value) for e in b], tag
    assert sorted(tags["images"]) == sorted(port_acc.Tags()["images"]) == [
        "scene1/val_render", "val/render"]
    for tag in tags["images"]:
        (a,), (b,) = jax_acc.Images(tag), port_acc.Images(tag)
        assert (a.step, a.height, a.width) == (b.step, b.height, b.width) == (2, 24, 32)
        np.testing.assert_array_equal(_pixels(a.encoded_image_string),
                                      _pixels(b.encoded_image_string))
    assert tags["tensors"] == port_acc.Tags()["tensors"] == ["config/text_summary"]
    (a,), (b,) = jax_acc.Tensors("config/text_summary"), port_acc.Tensors("config/text_summary")
    assert a.step == b.step and a.tensor_proto == b.tensor_proto
    assert b.tensor_proto.string_val == [text.encode()]
    md = port_acc.SummaryMetadata("config/text_summary")
    assert md == jax_acc.SummaryMetadata("config/text_summary")
    assert md.plugin_data.plugin_name == "text"
    for name, log_dir in dirs.items():       # EventAccumulator drops colorspace
        evs = [event_pb2.Event.FromString(r) for r in _records(_event_file(log_dir))]
        assert [v.image.colorspace for e in evs for v in e.summary.value
                if v.HasField("image")] == [3, 3], name


def _event_file(log_dir: str) -> str:
    (run,) = os.listdir(log_dir)
    (name,) = [f for f in os.listdir(os.path.join(log_dir, run))
               if f.startswith("events.out.tfevents.")]
    return os.path.join(log_dir, run, name)


def test_logger_without_tensorboard_writes_no_event_file(tmp_path):
    lg = MetricLogger(log_dir=str(tmp_path), config_text="x = 1", enable_tensorboard=False,
                      echo=lambda *_: None)
    lg.log_train(0, 1e-3, 0.5)
    lg.log_validation(0, 10.0, np.zeros((4, 4, 3), np.float32))
    lg.close()
    (run,) = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / run)) == ["config.txt", "train.log", "val_0000000.png"]


def test_fit_events_hold_its_train_log(tmp_path):
    """A port fit (CPU, tiny): its event file holds exactly the train.log
    scalars as float32, a val/render image a validation (within one level
    of its val PNG, which rounds where the event truncates) and the config
    text equal to config.txt."""
    root = str(tmp_path)
    make_synthetic_blender_scene(os.path.join(root, "scene"), h=8, w=8, num_train=2,
                                 num_val=1, num_test=1)
    cfg = Config(dataset_path=os.path.join(root, "scene"), num_random_rays=32,
                 num_samples=4, num_fine_samples=4, hidden_dim=16, num_iters=4,
                 log_interval=1, val_interval=2, save_interval=100,
                 save_path=os.path.join(root, "models"), log_dir=os.path.join(root, "logs"))
    fit(cfg, device="cpu", log=lambda *_: None)
    (run,) = os.listdir(cfg.log_dir)
    run_dir = os.path.join(cfg.log_dir, run)
    want = set()
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            if line.startswith("scalar "):
                _, tag, step, value = line.split()
                want.add((tag, int(step), float(np.float32(float(value)))))
    acc = _accumulate(cfg.log_dir)
    got = {(tag, e.step, e.value) for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}
    assert got == want and {t for t, _, _ in want} >= {
        "loss", "psnr", "learning_rate", "rays_per_sec", "val/psnr"}
    images = acc.Images("val/render")
    assert [e.step for e in images] == [2]
    png = np.asarray(Image.open(os.path.join(run_dir, "val_0000002.png")), np.int32)
    assert np.abs(_pixels(images[0].encoded_image_string).astype(np.int32) - png).max() <= 1
    with open(os.path.join(run_dir, "config.txt")) as f:
        assert acc.Tensors("config/text_summary")[0].tensor_proto.string_val == [
            f.read().encode()]
