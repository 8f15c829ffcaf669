"""The port's SpyNet (``video_analytics_tpu_torch/models/spynet.py``) against
the JAX package's on the same inputs and weights: the forward pass per
level on the bundled weights and on JAX-initialised ones, ``warp_by_flow``
and the flow's linear resize, the weights file and checkpoints crossing
between the packages both ways, the deep-supervision loss's gradients
against ``jax.value_and_grad``, one Adam step against ``optax.adam``, and
the synthetic-motion construction given the reference's own draws.  Then
the port's twins of ``tests/test_spynet.py``: the training machinery
learns, and the bundled weights recover synthetic motion.

Each JAX function runs jitted: eagerly (op by op) a SpyNet costs ~8 s at
each new shape on this CPU, jitted ~1.4 s."""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_analytics_tpu.models import spynet as jsn
from video_analytics_tpu.ops import kernels as jk
from video_analytics_tpu.runtime import checkpoint as jckpt
from video_analytics_tpu_torch.models import spynet as sn
from video_analytics_tpu_torch.models.convert import (
    spynet_flax_to_torch, spynet_torch_to_flax)
from video_analytics_tpu_torch.ops import kernels as pk
from video_analytics_tpu_torch.runtime import checkpoint as pckpt

torch.set_num_threads(1)

# Tolerances: the forward per level in px (measured 1.2e-6 at the finest
# level); gradients relative to each leaf's largest (measured 2.1e-6);
# the synthetic images on [0, 255] and their flow in px.
TOL_FLOW = 1e-5
TOL_LOSS = 1e-6
TOL_GRAD = 1e-5
TOL_ADAM = 1e-3
ADAM_EPS = 1e-8            # optax's and torch's default
TOL_IMG, TOL_GT = 1e-3, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(levels: int, seed: int):
    """The reference's ``init_spynet``, jitted, with numpy leaves."""
    return _np(jax.jit(lambda k: jsn.init_spynet(jsn.SpyNet(levels=levels),
                                                 k))(jax.random.PRNGKey(seed)))


def _jax_template(levels: int = 4):
    return {"params": _jax_init(levels, 0)["params"]}


@pytest.fixture(scope="module")
def bundled():
    """(JAX variables, port SpyNet) on the bundled weights, each package
    reading its own copy of the file."""
    jv = jckpt.load_variables(jsn.default_spynet_checkpoint(),
                              _jax_template())
    net = sn.SpyNet(levels=4)
    net.load_flax_variables(pckpt.load_variables(
        sn.default_spynet_checkpoint(), net.flax_variables()))
    return jv, net


def _pair(seed: int, b: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    nxt = np.roll(prev, (1, -2), axis=(1, 2))
    return prev, nxt


def _jax_apply(levels: int):
    model = jsn.SpyNet(levels=levels)
    return jax.jit(lambda v, a, b: model.apply(v, a, b,
                                                train_all_levels=True))


def _forward_both(jv, net, levels, prev, nxt):
    jf, jl = _jax_apply(levels)(jv, jnp.asarray(prev), jnp.asarray(nxt))
    with torch.no_grad():
        f, pl = net(torch.from_numpy(prev), torch.from_numpy(nxt),
                    train_all_levels=True)
    return (jf, jl), (f, pl)


@pytest.mark.parametrize("shape", [(2, 57, 75), (1, 33, 47)])
def test_forward_matches_reference_on_bundled_weights(bundled, shape):
    jv, net = bundled
    prev, nxt = _pair(sum(shape), *shape)
    (jf, jl), (f, pl) = _forward_both(jv, net, 4, prev, nxt)
    assert f.shape == (*shape, 2) and len(pl) == len(jl) == 4
    for k, (ours, ref) in enumerate(zip(pl, jl)):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL_FLOW, err_msg=f"level {k}")
    assert torch.equal(f, pl[-1])
    # Without train_all_levels: the final flow alone.
    with torch.no_grad():
        assert torch.equal(net(torch.from_numpy(prev),
                               torch.from_numpy(nxt)), f)


@pytest.mark.parametrize("levels", [2, 3])
def test_forward_matches_reference_on_jax_init(levels):
    """JAX-initialised weights (not the trained ones), converted to the
    port: every level's flow within TOL_FLOW."""
    jv = _jax_init(levels, levels)
    net = sn.SpyNet(levels=levels).load_flax_variables(jv)
    prev, nxt = _pair(57, 2, 57, 75)
    (_, jl), (_, pl) = _forward_both(jv, net, levels, prev, nxt)
    assert len(pl) == levels
    for ours, ref in zip(pl, jl):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL_FLOW)


def test_warp_by_flow_matches_reference(rng):
    """Flows that reach far outside the image (clamped) and fractional
    ones, on a 3-channel image."""
    img = rng.uniform(0, 255, (2, 13, 17, 3)).astype(np.float32)
    flow = rng.uniform(-30, 30, (2, 13, 17, 2)).astype(np.float32)
    flow[0] *= 0.05                                   # mostly inside
    ref = jk.warp_by_flow(jnp.asarray(img), jnp.asarray(flow))
    ours = pk.warp_by_flow(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_warp_by_flow_is_differentiable(rng):
    """Gradients reach both the image and the flow (SpyNet's training
    needs the warp's), and agree with JAX's."""
    img = rng.uniform(0, 255, (1, 9, 11, 1)).astype(np.float32)
    flow = rng.uniform(-2, 2, (1, 9, 11, 2)).astype(np.float32)
    weight = rng.normal(size=(1, 9, 11, 1)).astype(np.float32)

    def jloss(i, f):
        return jnp.sum(jk.warp_by_flow(i, f) * weight)

    gi, gf = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(img),
                                                      jnp.asarray(flow))
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    (pk.warp_by_flow(ti, tf) * torch.from_numpy(weight)).sum().backward()
    assert ti.grad.abs().sum() > 0 and tf.grad.abs().sum() > 0
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), atol=1e-3)


@pytest.mark.parametrize("src,dst", [((7, 9), (14, 18)),
                                     ((28, 37), (57, 75)),
                                     ((57, 75), (28, 37))])
def test_resize_linear_matches_reference(rng, src, dst):
    """The flow's ×2 upsampling (and a downsampling) over axes 1 and 2,
    ``jax.image.resize(linear, antialias=False)``."""
    x = rng.normal(size=(2, *src, 2)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 2), method="linear",
                           antialias=False)
    ours = pk.resize_linear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_bundled_weights_are_the_reference_file():
    """The port ships a byte-equal copy of the JAX package's weights."""
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    ours, ref = sn.default_spynet_checkpoint(), jsn.default_spynet_checkpoint()
    assert os.path.dirname(ours) != os.path.dirname(ref)
    assert sha(ours) == sha(ref)


def test_missing_bundled_weights_raise(monkeypatch):
    monkeypatch.setattr(sn.os.path, "exists", lambda p: False)
    with pytest.raises(FileNotFoundError, match="--spynet-checkpoint"):
        sn.default_spynet_checkpoint()


def test_checkpoints_cross_between_packages(tmp_path):
    """A SpyNet saved by the port loads in JAX with ``init_spynet``'s
    template and computes the same flow; one saved by JAX loads in the
    port with its leaves unchanged."""
    net = sn.init_spynet(sn.SpyNet(levels=4),
                         torch.Generator().manual_seed(5))
    ours = str(tmp_path / "port.msgpack")
    pckpt.save_variables(ours, net.flax_variables())
    jv = jckpt.load_variables(ours, _jax_template())
    prev, nxt = _pair(3, 1, 33, 47)
    (jf, _), (f, _) = _forward_both(jv, net, 4, prev, nxt)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=TOL_FLOW)

    theirs = str(tmp_path / "jax.msgpack")
    jref = _jax_init(4, 9)
    jckpt.save_variables(theirs, jref)
    back = sn.SpyNet(levels=4)
    back.load_flax_variables(pckpt.load_variables(theirs,
                                                  back.flax_variables()))
    got = back.flax_variables()["params"]
    for level, convs in jref["params"].items():
        for name, leaves in convs.items():
            for leaf, value in leaves.items():
                assert np.array_equal(got[level][name][leaf], value), (
                    level, name, leaf)


def test_conv_flops():
    """The bound's operation count: 467,264 a pixel and level."""
    assert sn.conv_flops(1, 8, 8, levels=1) == 467264 * 64
    assert sn.conv_flops(15, 224, 224) / 1e9 == pytest.approx(467.08,
                                                              abs=0.01)
    assert sn.conv_flops(1, 1080, 1920) / 1e12 == pytest.approx(1.2868,
                                                                 abs=1e-4)


def test_init_follows_flax_defaults():
    """LeCun-normal kernels (variance 1/fan_in, truncated at 2σ), zero
    biases, reproducible from the generator's seed."""
    a = sn.init_spynet(sn.SpyNet(levels=2), torch.Generator().manual_seed(1))
    b = sn.init_spynet(sn.SpyNet(levels=2), torch.Generator().manual_seed(1))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("bias"):
            assert not pa.any(), name
        else:
            fan_in = pa[0].numel()
            std = float(pa.detach().std()) * fan_in ** 0.5
            assert 0.85 < std < 1.15, (name, std)
            assert (float(pa.detach().abs().max()) * fan_in ** 0.5
                    < 2.0 / 0.8796 + 1e-4)


# -- training ---------------------------------------------------------------

def _reference_loss_fn(model):
    """The reference's deep-supervision loss
    (``video_analytics_tpu/models/spynet.py:255-267``), restated: it is a
    closure inside ``make_spynet_train_step`` there."""
    def loss_fn(params, prev, nxt, gt):
        flow, per_level = model.apply({"params": params}, prev, nxt,
                                      train_all_levels=True)
        loss = 0.0
        for f in per_level:
            b, h, w, _ = f.shape
            gt_k = jax.image.resize(gt, (b, h, w, 2), method="linear",
                                    antialias=False) * (h / gt.shape[1])
            loss = loss + jnp.mean(
                jnp.sqrt(jnp.sum((f - gt_k) ** 2, -1) + 1e-6))
        epe = jnp.mean(jnp.sqrt(jnp.sum((flow - gt) ** 2, -1) + 1e-8))
        return loss, epe
    return loss_fn


@pytest.fixture(scope="module")
def fixed_batch():
    """One synthetic batch from the reference's generator (blobs on), as
    numpy arrays both packages take."""
    prev, nxt, gt = jax.jit(lambda k: jsn.synthetic_pair(
        k, 2, 33, 47, local_blobs=1))(jax.random.PRNGKey(21))
    return np.asarray(prev), np.asarray(nxt), np.asarray(gt)


@pytest.fixture(scope="module")
def reference_grads(bundled, fixed_batch):
    jv, _ = bundled
    (loss, epe), grads = jax.jit(jax.value_and_grad(
        _reference_loss_fn(jsn.SpyNet(levels=4)), has_aux=True))(
        jv["params"], *map(jnp.asarray, fixed_batch))
    return float(loss), float(epe), {"params": _np(grads)}


def _port_net(jv) -> sn.SpyNet:
    return sn.SpyNet(levels=4).load_flax_variables(_np(jv))


def test_loss_gradients_match_reference(bundled, fixed_batch,
                                        reference_grads):
    jv, _ = bundled
    loss_ref, epe_ref, grads_ref = reference_grads
    net = _port_net(jv)
    loss, epe = sn.spynet_loss(net, *map(torch.from_numpy, fixed_batch))
    loss.backward()
    assert loss.item() == pytest.approx(loss_ref, rel=TOL_LOSS)
    assert epe.item() == pytest.approx(epe_ref, rel=TOL_LOSS)
    grads = spynet_torch_to_flax(
        {k: p.grad for k, p in net.named_parameters()})["params"]
    reached = dict.fromkeys(grads, 0)
    for level, convs in grads_ref["params"].items():
        for name, leaves in convs.items():
            for leaf, ref in leaves.items():
                got = grads[level][name][leaf]
                # A leaf behind ReLUs that are off on this batch has no
                # gradient in either package.
                scale = max(np.abs(ref).max(), 1e-30)
                err = np.abs(got - ref).max() / scale
                assert err <= TOL_GRAD, (level, name, leaf, err)
                reached[level] += int(np.count_nonzero(ref))
    assert all(reached.values()), reached         # every level learns


def test_one_adam_step_matches_optax(bundled, fixed_batch, reference_grads):
    """One step of torch Adam (``make_spynet_train_step``'s optimizer)
    against ``optax.adam`` on the same batch: each leaf's update within
    TOL_ADAM of the update's size (the rule of the two-stream SGD steps).

    Adam's first update is about lr·sign(g) wherever |g| ≫ ε, so it is held
    twice: given the reference's gradients, everywhere; and from the
    port's own gradients of the batch, wherever the update does not hang on
    rounding: the two packages' gradients agree on the sign (|g_ref| above
    twice their difference) and |g| ≥ 1e3·ε, where a relative change r of
    |g| moves g / (|g| + ε) by at most r·ε/|g| ≤ 5e-4."""
    jv, _ = bundled
    _, _, grads_ref = reference_grads
    lr = 1e-3
    tx = optax.adam(lr, eps=ADAM_EPS)
    params = jv["params"]
    want_tree = _np(tx.update(grads_ref["params"], tx.init(params),
                              params)[0])
    ref_sd = spynet_flax_to_torch(grads_ref)
    for own_grads in (False, True):
        net = _port_net(jv)
        before = net.flax_variables()["params"]
        opt = torch.optim.Adam(net.parameters(), lr=lr, eps=ADAM_EPS)
        if own_grads:
            loss, _ = sn.spynet_loss(net, *map(torch.from_numpy,
                                               fixed_batch))
            loss.backward()
            port_grads = spynet_torch_to_flax(
                {k: p.grad for k, p in net.named_parameters()})["params"]
        else:
            for k, p in net.named_parameters():
                p.grad = ref_sd[k].clone()
        opt.step()
        after = net.flax_variables()["params"]
        compared = 0
        for level, convs in want_tree.items():
            for name, leaves in convs.items():
                for leaf, want in leaves.items():
                    got = (after[level][name][leaf]
                           - before[level][name][leaf])
                    keep = np.ones(want.shape, bool)
                    if own_grads:
                        g = grads_ref["params"][level][name][leaf]
                        keep = (np.abs(g) > 2 * np.abs(
                            port_grads[level][name][leaf] - g)) & (
                            np.abs(g) >= 1e3 * ADAM_EPS)
                    compared += int(keep.sum())
                    if not keep.any():
                        continue
                    err = (np.abs(got - want)[keep].max()
                           / max(np.abs(want).max(), 1e-30))
                    assert err <= TOL_ADAM, (own_grads, level, name, leaf,
                                             err)
        assert compared > 0, own_grads


def _jax_draws(key, batch, h, w, local_blobs=0, full_affine=False,
               hard_objects=0):
    """The reference's random arrays for `key`, in the key-split order of
    ``video_analytics_tpu/models/spynet.py:151-226``, under the port's
    names (``synthetic_pair_draws``)."""
    u = jax.random.uniform
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d = {"base": u(k1, (batch, h + 16, w + 16), minval=0.0, maxval=255.0),
         "t": u(k2, (batch, 1, 1, 2), minval=-3.0, maxval=3.0)}
    if full_affine:
        kt, ks = jax.random.split(k3)
        d["theta"] = u(kt, (batch, 1, 1), minval=-0.07, maxval=0.07)
        d["s"] = u(ks, (batch, 1, 1), minval=0.95, maxval=1.07)
    else:
        d["a"] = u(k3, (batch, 1, 1, 2), minval=-1.0, maxval=1.0)
    if local_blobs:
        kc, ks, ku = jax.random.split(k4, 3)
        d["blob_c"] = u(kc, (batch, local_blobs, 2), minval=0.15,
                        maxval=0.85)
        d["blob_sig"] = u(ks, (batch, local_blobs, 1, 1), minval=0.06,
                          maxval=0.2)
        d["blob_u"] = u(ku, (batch, local_blobs, 1, 1, 2), minval=-3.0,
                        maxval=3.0)
    if hard_objects:
        kc, khs, ku, ktex = jax.random.split(k5, 4)
        d["obj_tex"] = u(ktex, (batch, h, w), minval=0.0, maxval=255.0)
        d["obj_c"] = u(kc, (batch, hard_objects, 2), minval=0.2, maxval=0.8)
        d["obj_half"] = u(khs, (batch, hard_objects, 1, 1), minval=0.05,
                          maxval=0.12)
        d["obj_u"] = u(ku, (batch, hard_objects, 2), minval=-4.0,
                       maxval=4.0)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


REGIMES = {"plain": {},
           "full_affine": {"full_affine": True},
           "hard_objects": {"hard_objects": 2, "local_blobs": 2}}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_synthetic_pair_from_draws_matches_reference(regime):
    kw = REGIMES[regime]
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda k: jsn.synthetic_pair(k, 2, 40, 48, **kw))(key)
    draws = _jax_draws(key, 2, 40, 48, **kw)
    ours = sn.synthetic_pair_from_draws(draws)
    for name, o, r, tol in zip(("prev", "nxt", "gt"), ours, ref,
                               (TOL_IMG, TOL_IMG, TOL_GT)):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=tol, err_msg=name)
    # The port's own draws have the reference's shapes and ranges.
    mine = sn.synthetic_pair_draws(torch.Generator().manual_seed(0), 2, 40,
                                   48, **kw)
    assert {k: v.shape for k, v in mine.items()} == {
        k: v.shape for k, v in draws.items()}
    for k in mine:
        lo, hi = float(draws[k].min()), float(draws[k].max())
        assert float(mine[k].min()) >= min(lo, -4.0) - 1e-6, k
        assert float(mine[k].max()) <= max(hi, 255.0) + 1e-6, k


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_synthetic_pair_is_consistent(regime):
    """Port twin of ``test_synthetic_pair_consistency`` and
    ``test_synthetic_pair_hard_regimes``: warping nxt by gt gives prev back
    (away from occlusions), the similarity field curls, and the squares
    make the flow jump."""
    prev, nxt, gt = sn.synthetic_pair(torch.Generator().manual_seed(3), 2,
                                      48, 64, **REGIMES[regime])
    assert prev.shape == nxt.shape == (2, 48, 64) and gt.shape == (2, 48, 64,
                                                                   2)
    rec = pk.warp_by_flow(nxt[..., None], gt)[..., 0]
    err = (rec - prev).abs()[:, 8:-8, 8:-8]
    assert float(err.median()) < 6.0 and float(err.mean()) < 6.0
    g = gt.numpy()
    if regime == "full_affine":
        curl = np.abs(np.gradient(g[..., 0], axis=1)
                      - np.gradient(g[..., 1], axis=2)).mean()
        assert curl > 1e-3, curl
    if regime == "hard_objects":
        assert np.abs(np.diff(g[..., 0], axis=2)).max() > 1.0


def test_training_machinery_learns():
    """Port twin of ``tests/test_spynet.py::test_training_machinery_learns``:
    gradients reach every level (through the warp) and 150 Adam steps at
    1e-2 halve the EPE of a shared translation."""
    torch.manual_seed(0)
    net = sn.init_spynet(sn.SpyNet(levels=2),
                         torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    base = pk.gaussian_blur(torch.rand((4, 48, 48), generator=g) * 255.0,
                            1.0)
    gt = torch.tensor([1.5, -1.0]).expand(4, 32, 32, 2)
    gt_pad = torch.tensor([1.5, -1.0]).expand(4, 48, 48, 2)
    nxt = pk.warp_by_flow(base[..., None], -gt_pad)[:, 8:40, 8:40, 0]
    prev = base[:, 8:40, 8:40]

    def loss_fn():
        flow = net(prev, nxt)
        return torch.sqrt(((flow - gt) ** 2).sum(-1) + 1e-8).mean()

    loss = loss_fn()
    loss.backward()
    for k, level in enumerate(net.nets):
        total = sum(float(p.grad.abs().sum()) for p in level.parameters())
        assert total > 0, f"no gradient for level{k}"
    init_epe = loss.item()
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(150):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    with torch.no_grad():
        final_epe = float(loss_fn())
    assert final_epe < init_epe * 0.5, (init_epe, final_epe)


def test_train_step_learns_from_the_bundled_weights(bundled):
    """``make_spynet_train_step`` draws a batch, returns finite (loss,
    epe) and moves the weights; the same seed gives the same step."""
    _, net = bundled
    results = []
    for _ in range(2):
        m = sn.SpyNet(levels=4).load_flax_variables(net.flax_variables())
        step = sn.make_spynet_train_step(
            m, torch.optim.Adam(m.parameters(), lr=1e-4), batch=2,
            hw=(32, 32), local_blobs=1, hard_objects=1)
        loss, epe = step(torch.Generator().manual_seed(4))
        assert np.isfinite(float(loss)) and 0 < float(epe) < float(loss)
        results.append((float(loss), m.nets[0].conv0.weight.detach()))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    assert not torch.equal(results[0][1], net.nets[0].conv0.weight)


def test_bundled_checkpoint_recovers_motion(bundled):
    """Port twin of ``tests/test_spynet.py::
    test_bundled_checkpoint_recovers_motion``, on the port's own draws."""
    _, net = bundled
    prev, nxt, gt = sn.synthetic_pair(torch.Generator().manual_seed(123), 4,
                                      96, 96)
    with torch.no_grad():
        flow = net(prev, nxt)
    epe = torch.sqrt(((flow - gt) ** 2).sum(-1))
    assert float(epe.mean()) < 0.3, float(epe.mean())
