"""The port's checkpoints against the JAX package's: one file format
(flax msgpack), read and written by both.

A file written by JAX ``save_variables`` loads in the port, one written
by the port loads with JAX ``load_variables``, and the two-stream
classifier gives the same probabilities on either side (atol 1e-4, the
bound tests/test_torch_models.py holds ``classify_window`` to).  The
port's own msgpack writer is held to flax's bytes, its reader to flax's
trees.
"""

import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import moving_square_frames
from video_analytics_tpu import config as jax_config
from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.runtime import checkpoint as jax_ckpt
from video_analytics_tpu.runtime import pipeline as jax_pipeline
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime import checkpoint as ckpt
from video_analytics_tpu_torch.runtime import pipeline

torch.set_num_threads(1)

WIDTH, CLASSES, STACK = 8, 5, 3
CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=72, crop=64, flow_stack=STACK),
    window=4, num_classes=CLASSES, flow_algo="farneback",
    farneback=FarnebackConfig(levels=1, iterations=1))
JAX_CFG = jax_config.PipelineConfig(
    preprocess=jax_config.PreprocessConfig(
        **dataclasses.asdict(CFG.preprocess)),
    window=4, num_classes=CLASSES, flow_algo="farneback",
    farneback=jax_config.FarnebackConfig(
        **dataclasses.asdict(CFG.farneback)))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(seed: int):
    """The JAX model with seeded weights and BatchNorm statistics that are
    not the initial 0 and 1, so that every leaf of the file matters."""
    jm = JaxTS.create(num_classes=CLASSES, flow_stack=STACK, width=WIDTH)
    variables = _numpy(jm.init_variables(jax.random.PRNGKey(seed),
                                         input_hw=(32, 32)))
    rng = np.random.default_rng(seed)
    for stream in variables.values():
        stream["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                       else rng.normal(0, 0.1, a.shape)).astype(np.float32),
            stream["batch_stats"])
    return jm, variables


def _port_model():
    return TwoStreamModel.create(num_classes=CLASSES, flow_stack=STACK,
                                 width=WIDTH)


def _clip():
    return np.stack(moving_square_frames(4, 80, 96, step=(2, 1)))


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_jax_checkpoint_loads_in_port(tmp_path):
    jm, variables = _jax_model(0)
    path = str(tmp_path / "jax.msgpack")
    jax_ckpt.save_variables(path, variables)
    tm = _port_model()
    loaded = ckpt.load_variables(path, tm.flax_variables())
    _assert_trees_equal(loaded, variables)
    tm.load_flax_variables(loaded).eval()
    frames = _clip()
    ref = np.asarray(jax_pipeline.classify_window(
        jnp.asarray(frames), variables, jm, JAX_CFG))
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, CFG)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tm = _port_model().init(torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():                  # statistics away from 0 and 1
        for name, buf in tm.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5,
                             generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "sub" / "port.msgpack")     # the directory is made
    ckpt.save_variables(path, tm.flax_variables())
    jm, template = _jax_model(1)
    variables = jax_ckpt.load_variables(path, template)
    _assert_trees_equal(_numpy(variables), tm.flax_variables())
    frames = _clip()
    ref = np.asarray(jax_pipeline.classify_window(
        jnp.asarray(frames), variables, jm, JAX_CFG))
    ours = pipeline.classify_window(torch.from_numpy(frames), tm, CFG)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # ... and back into a second port model, to the bit.
    again = _port_model().load_flax_variables(
        ckpt.load_variables(path, _port_model().flax_variables()))
    for k, v in tm.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _mixed_tree(rng):
    return {
        "params": {"w": rng.normal(0, 1, (3, 4, 5)).astype(np.float32),
                   "b": rng.normal(0, 1, (70000,)).astype(np.float64),
                   "empty": np.zeros((0, 3), np.float32),
                   "scalar_array": np.array(2.5, np.float32),
                   "i": rng.integers(-9, 9, (7,), dtype=np.int32),
                   "u8": rng.integers(0, 255, (2, 300), dtype=np.uint8),
                   "flag": np.array([True, False])},
        "step": 12345, "negative": -40000, "tiny": -3, "big": 2 ** 40,
        "lr": 0.125, "name": "two-stream", "none": None, "yes": True,
        "no": False, "np_scalar": np.float32(1.5), "np_int": np.int64(-7),
        "k" * 40: {"long key": "x" * 300},
        "many": {f"k{i}": i for i in range(20)}}


def _sorted(tree):
    """`tree` with every map's keys in sorted order, the order in which
    flax writes them (it rebuilds the tree with jax.tree_util first)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_writer_gives_flax_bytes(rng):
    """The same tree with its keys in flax's (sorted) order packs to the
    bytes ``flax.serialization.msgpack_serialize`` writes."""
    tree = _mixed_tree(rng)
    assert (ckpt._pack(_sorted(tree))
            == flax.serialization.msgpack_serialize(tree))
    jm, variables = _jax_model(2)
    assert (ckpt._pack(_sorted(variables))
            == flax.serialization.to_bytes(variables))


def test_reader_restores_what_flax_restores(tmp_path, rng):
    tree = _mixed_tree(rng)
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(tree))
    ours = ckpt.load_variables(path)
    ref = flax.serialization.msgpack_restore(open(path, "rb").read())
    assert set(ours) == set(ref)
    _assert_trees_equal(ours["params"], ref["params"])
    for k in ("step", "negative", "tiny", "big", "lr", "name", "none", "yes",
              "no", "many"):
        assert ours[k] == ref[k] and type(ours[k]) is type(ref[k]), k
    for k in ("np_scalar", "np_int"):
        assert ours[k] == ref[k] and ours[k].dtype == ref[k].dtype, k


def test_sequences_are_saved_as_flax_saves_them(tmp_path):
    """flax stores a list or tuple as a map keyed "0", "1", ..."""
    tree = {"layers": [np.arange(3.0), np.ones((2, 2), np.float32)]}
    path = str(tmp_path / "s.msgpack")
    ckpt.save_variables(path, tree)
    assert open(path, "rb").read() == flax.serialization.to_bytes(tree)
    assert flax.serialization.from_bytes(tree, open(path, "rb").read())[
        "layers"][0].tolist() == [0.0, 1.0, 2.0]
    back = ckpt.load_variables(path)
    assert sorted(back["layers"]) == ["0", "1"]
    assert np.array_equal(back["layers"]["1"], tree["layers"][1])


def test_chunked_leaves_round_trip_through_both(tmp_path, rng, monkeypatch):
    """A leaf above the chunk limit is split as flax splits it; the limit
    is lowered here so that a small array takes that path."""
    monkeypatch.setattr(ckpt, "_MAX_CHUNK_BYTES", 4096)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    tree = {"w": rng.normal(0, 1, (50, 41)).astype(np.float32),
            "small": np.arange(5, dtype=np.int32)}
    path = str(tmp_path / "c.msgpack")
    ckpt.save_variables(path, _sorted(tree))
    data = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in data
    assert data == flax.serialization.msgpack_serialize(tree)
    _assert_trees_equal(ckpt.load_variables(path, tree), tree)
    _assert_trees_equal(flax.serialization.msgpack_restore(data), tree)


def test_torch_leaves_are_saved(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = str(tmp_path / "t.msgpack")
    ckpt.save_variables(path, tree)
    back = ckpt.load_variables(path, tree)
    assert np.array_equal(back["w"], tree["w"].numpy())
    assert back["w"].dtype == np.float32


def test_save_replaces_atomically(tmp_path):
    path = str(tmp_path / "a.msgpack")
    ckpt.save_variables(path, {"w": np.zeros(3, np.float32)})
    ckpt.save_variables(path, {"w": np.ones(3, np.float32)})
    assert os.listdir(tmp_path) == ["a.msgpack"]         # no .tmp left
    assert np.array_equal(ckpt.load_variables(path)["w"], np.ones(3))


@pytest.mark.parametrize("fault", ["keys", "shape", "truncated", "trailing",
                                   "bad_key", "bad_leaf"])
def test_faults_are_refused(tmp_path, fault):
    path = str(tmp_path / "f.msgpack")
    tree = {"params": {"w": np.zeros((2, 3), np.float32)}}
    ckpt.save_variables(path, tree)
    if fault == "keys":
        with pytest.raises(ValueError, match="expected keys"):
            ckpt.load_variables(path, {"params": {"w": tree["params"]["w"],
                                                  "b": np.zeros(3)}})
    elif fault == "shape":
        with pytest.raises(ValueError, match="expected shape"):
            ckpt.load_variables(path, {"params": {"w": np.zeros((3, 2))}})
    elif fault == "truncated":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-5])
        with pytest.raises(ValueError, match="truncated"):
            ckpt.load_variables(path)
    elif fault == "trailing":
        open(path, "ab").write(b"\x00")
        with pytest.raises(ValueError, match="trailing"):
            ckpt.load_variables(path)
    elif fault == "bad_key":
        with pytest.raises(TypeError, match="keys must be str"):
            ckpt.save_variables(path, {1: np.zeros(2)})
    else:
        with pytest.raises(TypeError, match="cannot save"):
            ckpt.save_variables(path, {"w": object()})
