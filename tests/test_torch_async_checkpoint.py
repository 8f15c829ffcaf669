"""``runtime/checkpoint.AsyncCheckpointer`` on the CPU.

The cases of ``tests/test_cli.py``'s orbax tests (a round trip into a
template, restore into the template's placement, rotation to ``.prev``
and the fallback when the primary is lost), then: the file inside the
directory is read by the JAX package's ``load_variables``; ``save``
returns before the write commits and after the tree is staged (a writer
held back on purpose); a background error is raised by the next
``wait()``, ``save()`` or ``close()``; a torn primary falls back, and a
template that does not match raises.  The card's staging (CUDA leaves
into pinned buffers) is in ``tests/test_torch_cuda.py``.
"""

import os
import shutil
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from video_analytics_tpu.models.two_stream import TwoStreamModel as JaxTS
from video_analytics_tpu.runtime.checkpoint import (
    load_variables as jax_load)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime.checkpoint import AsyncCheckpointer

torch.set_num_threads(1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _model(seed: int) -> TwoStreamModel:
    return TwoStreamModel.create(num_classes=5, width=16).init(
        torch.Generator().manual_seed(seed))


def test_async_checkpoint_roundtrip(tmp_path):
    """Async save, restore into a template's structure, and restore into
    a template of tensors: each leaf lands with the template's dtype and
    device."""
    v = _model(1).flax_variables()
    path = str(tmp_path / "ck1")
    with AsyncCheckpointer() as ck:
        ck.save(path, v)
        ck.wait()
        assert os.listdir(path) == [AsyncCheckpointer.FILE]
        restored = ck.restore(path, _model(2).flax_variables())
        for (k, a), (k2, b) in zip(_leaves(v), _leaves(restored)):
            assert k == k2 and isinstance(b, np.ndarray)
            assert b.dtype == a.dtype and np.array_equal(a, b), k
        template = _model(2).double().state_dict()
        ck.save(str(tmp_path / "sd"), _model(1).state_dict())
        placed = ck.restore(str(tmp_path / "sd"), template)
    assert list(placed) == list(template)
    for k, t in _model(1).state_dict().items():
        assert placed[k].dtype == template[k].dtype
        assert placed[k].device == template[k].device
        assert torch.equal(placed[k], t.to(template[k].dtype)), k


def test_async_rotation_preserves_previous(tmp_path):
    path = str(tmp_path / "ck")
    t1 = {"w": np.arange(4.0)}
    t2 = {"w": np.arange(4.0) + 10.0}
    template = {"w": np.zeros(4)}
    with AsyncCheckpointer() as ck:
        ck.save(path, t1)
        ck.save(path, t2)          # rotates t1 → ck.prev
        ck.wait()
        assert os.path.isdir(path + ".prev")
        np.testing.assert_array_equal(ck.restore(path, template)["w"],
                                      t2["w"])
        shutil.rmtree(path)
        with pytest.warns(RuntimeWarning, match="missing or torn"):
            got = ck.restore(path, template)["w"]
        np.testing.assert_array_equal(got, t1["w"])
        # keep_previous=False replaces the primary and rotates nothing.
        shutil.rmtree(path + ".prev")
        ck.save(path, t1)
        ck.save(path, t2, keep_previous=False)
        ck.wait()
        assert not os.path.exists(path + ".prev")
        np.testing.assert_array_equal(ck.restore(path, template)["w"],
                                      t2["w"])


def test_torn_primary_falls_back_and_other_failures_raise(tmp_path):
    path = str(tmp_path / "ck")
    template = {"w": np.zeros(4)}
    with AsyncCheckpointer() as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore(path, template)
        ck.save(path, {"w": np.arange(4.0)})
        ck.save(path, {"w": np.arange(4.0) + 1})
        ck.wait()
        inside = os.path.join(path, AsyncCheckpointer.FILE)
        data = open(inside, "rb").read()
        with open(inside, "wb") as f:       # a crash cut the file short
            f.write(data[:len(data) // 2])
        with pytest.warns(RuntimeWarning, match="torn"):
            got = ck.restore(path, template)["w"]
        np.testing.assert_array_equal(got, np.arange(4.0))
        with open(inside, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(ValueError, match="does not match"):
                ck.restore(path, {"w": np.zeros(5)})
            with pytest.raises(ValueError, match="does not match"):
                ck.restore(path, {"v": np.zeros(4)})


def test_reference_reads_the_file_inside(tmp_path):
    model = TwoStreamModel.create(num_classes=5, flow_stack=3, width=8).init(
        torch.Generator().manual_seed(3))
    path = str(tmp_path / "ck")
    with AsyncCheckpointer() as ck:
        ck.save(path, model.flax_variables())
    template = JaxTS.create(num_classes=5, flow_stack=3, width=8
                            ).init_variables(jax.random.PRNGKey(0))
    ref = jax_load(os.path.join(path, AsyncCheckpointer.FILE), template)
    ours = dict(_leaves(model.flax_variables()))
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert sorted(got) == sorted(ours)
    for k in ours:
        assert np.array_equal(got[k], ours[k]), k


def test_save_returns_before_the_write_commits(tmp_path):
    """The writer is held until the test lets it go: ``save`` has returned
    by then, the directory is not there yet, and a tensor the caller
    changes after ``save`` is saved as it was."""
    path = str(tmp_path / "ck")
    go, entered = threading.Event(), threading.Event()
    w = torch.arange(6.0)
    with AsyncCheckpointer() as ck:
        real = ck._write

        def held(*args):
            entered.set()
            assert go.wait(60)
            real(*args)

        ck._write = held
        ck.save(path, {"w": w, "n": {"k": np.ones(3)}})
        assert entered.wait(60)
        assert not os.path.exists(path)
        w.add_(100.0)                      # the next step changes it
        go.set()
        ck.wait()
        assert os.path.isdir(path)
        back = ck.restore(path, {"w": torch.zeros(6),
                                 "n": {"k": np.zeros(3)}})
    assert torch.equal(back["w"], torch.arange(6.0))
    assert np.array_equal(back["n"]["k"], np.ones(3))


def test_one_save_in_flight(tmp_path):
    """A second save waits for the first to commit, then rotates it."""
    path = str(tmp_path / "ck")
    go = threading.Event()
    with AsyncCheckpointer() as ck:
        real = ck._write

        def held(*args):
            assert go.wait(60)
            real(*args)

        ck._write = held
        ck.save(path, {"w": np.zeros(2)})
        threading.Timer(0.2, go.set).start()
        ck.save(path, {"w": np.ones(2)})
        assert os.path.isdir(path + ".prev")
        ck.wait()
        assert np.array_equal(
            ck.restore(path + ".prev", {"w": np.empty(2)})["w"], np.zeros(2))


@pytest.mark.parametrize("then", ["wait", "save", "close"])
def test_background_error_is_raised(tmp_path, then):
    """A write that fails on the writer thread (its parent is a regular
    file) is raised by the next call, once, never swallowed."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = str(blocker / "ck")
    ck = AsyncCheckpointer()
    ck.save(bad, {"w": np.zeros(2)})
    with pytest.raises(NotADirectoryError):
        if then == "wait":
            ck.wait()
        elif then == "save":
            ck.save(str(tmp_path / "good"), {"w": np.zeros(2)})
        else:
            ck.close()
    if then != "close":
        ck.save(str(tmp_path / "good"), {"w": np.ones(2)})
        ck.close()
        assert os.path.isdir(tmp_path / "good")
