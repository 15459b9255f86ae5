"""The learned operator's trainer in the PyTorch port against the JAX
package, on CPU.  Inputs are made with numpy from a seed; the port takes
them channels-first, the JAX package channels-last.

* ``models/train.py``: `masked_mse` (rtol 1e-5, the trainer's loss bound; the padding case of
  tests/test_train.py:72-76 exactly); the pair's shapes and mask count
  (tests/test_train.py:46-57, exactly); `make_trainer` against JAX
  ``make_trainer`` from the same parameters (``random_flax_unet_params``
  -> ``unet_state_dict_from_flax``), width 4, tests/test_train.py's
  example: Adam 5 steps at lr 1e-4 and AdamW 5 steps at lr 1e-3 with
  decay 1e-2, losses within 1e-5 relative and parameters within
  1e-2 * lr * steps (one hundredth of the furthest Adam can move them);
  the loss falls over 15 steps (tests/test_train.py:60-69); the trainer's
  init against Flax ``model.init`` in distribution (zero biases, every
  kernel's std within INIT_SIGMAS standard errors of Flax's,
  |w| <= 2 x the truncated normal's std, the pooled standardized kernels
  a truncated normal by a Kolmogorov-Smirnov test); a training step's
  backward under the precise flags whatever the process's flags;
  `train`'s checkpoint read by both packages' loaders.
* ``models/unet3d.py``: `FastUnpool` against JAX ``FastUnpool`` and
  ``F.conv_transpose3d`` (atol 1e-5, tests/test_unet.py:180-198); a
  width-8 ``UNet3D(fast_unpool=True)`` against the Flax one (atol 2e-5,
  tests/test_torch_unet.py's) and against its own transposed-conv form
  (atol 1e-5); `AvgPool2`: forward bitwise ``F.avg_pool3d``, backward by
  ``torch.autograd.gradcheck`` in float64.
* `generate_training_data` on tests/test_train.py:79-98's dam-break
  config against JAX ``generate_training_data`` from the same scene state,
  with tests/test_torch_flagship.py's exact-sum patch of the JAX
  package's CPU segment sums applied in the test: masks and the solid
  channel bitwise, the rest within GEN_TOL (6 steps: the sixth pair is
  the first whose target is not near zero).
* ``models/train_unet_prod.py``: capture, train (and a resumed train)
  and eval at width 4 on a coarse buckling config, in tmp_path.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch
import torch.nn.functional as F

from python_fluid_simulation_tpu.config import GridConfig3D as JGrid
from python_fluid_simulation_tpu.config import PhysicsConfig as JPhysics
from python_fluid_simulation_tpu.config import SimConfig as JSimConfig
from python_fluid_simulation_tpu.config import SolverConfig as JSolver
from python_fluid_simulation_tpu.models import convert as j_convert
from python_fluid_simulation_tpu.models import train as j_train
from python_fluid_simulation_tpu.models.unet3d import FastUnpool as JFastUnpool
from python_fluid_simulation_tpu.models.unet3d import UNet3D as JUNet3D
from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
from python_fluid_simulation_tpu_torch.convert import (
    load_reference_checkpoint,
    random_flax_unet_params,
    state_from_numpy,
    unet_state_dict_from_flax,
)
from python_fluid_simulation_tpu_torch.models import train, train_unet_prod
from python_fluid_simulation_tpu_torch.models.unet3d import AvgPool2, FastUnpool, UNet3D, precise_flags

torch.set_num_threads(1)

INIT_SIGMAS = 6  # standard errors of the difference of two sample stds
# generate_training_data, port vs JAX over the dam break's first 6 pairs
# (the first five from near-uniform flow, targets below 2e-6; the sixth's
# up to 16.6); measured maxima: velocity gradients 3.6e-7 (entries up to
# 0.95), targets 3.8e-6, the volume channel 1.04e-7 (entries up to 0.125);
# the bounds are ten times those
GEN_STEPS = 6
GEN_TOL = dict(x=3.6e-6, y=3.8e-5, lvol=1.0e-6)


def _layout_j(x):
    """(N, C, D, H, W) -> (N, D, H, W, C)."""
    return np.transpose(np.asarray(x), (0, 2, 3, 4, 1))


def _layout_t(x):
    """(N, D, H, W, C) -> (N, C, D, H, W)."""
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 4, 1, 2, 3)))


def _tiny(jax_side):
    """tests/test_train.py's tiny config, in either package."""
    G, P, S = (JGrid, JPhysics, JSimConfig) if jax_side else (GridConfig3D, PhysicsConfig, SimConfig)
    return S(grid=G(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 6),
             physics=P(dt=1.0 / 60.0), particle_dx=1.0 / 12)


def _example_arrays(seed=0):
    """tests/test_train.py::_example's fields, as numpy arrays."""
    cfg = _tiny(False)
    rng = np.random.default_rng(seed)
    n, dual = cfg.grid.res, cfg.grid.dual_res
    shapes = [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]
    gv0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sphi = rng.standard_normal(dual).astype(np.float32)
    lvol = rng.random(dual).astype(np.float32) * np.float32(cfg.grid.dx**3)
    return gv0, [v * np.float32(0.9) for v in gv0], sphi, lvol


def _examples(seed=0):
    gv0, gv1, sphi, lvol = _example_arrays(seed)
    t = [tuple(map(torch.from_numpy, gv0)), tuple(map(torch.from_numpy, gv1)), torch.from_numpy(sphi),
         torch.from_numpy(lvol)]
    j = [tuple(map(jnp.asarray, gv0)), tuple(map(jnp.asarray, gv1)), jnp.asarray(sphi), jnp.asarray(lvol)]
    return train.capture_viscosity_pair(*t, _tiny(False)), j_train.capture_viscosity_pair(*j, _tiny(True))


# -- the loss and the pair


@pytest.mark.parametrize("shape", [(1, 3, 4, 4, 4), (2, 3, 16, 8, 12)])
def test_masked_mse_matches_jax(shape):
    rng = np.random.default_rng(1)
    pred, target = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    mask = (rng.random(shape) < 0.3).astype(np.float32)
    got = float(train.masked_mse(*map(torch.from_numpy, (pred, target, mask))))
    want = float(j_train.masked_mse(*(jnp.asarray(_layout_j(a)) for a in (pred, target, mask))))
    assert got == pytest.approx(want, rel=1e-5)  # fp32 sums in another order


def test_masked_mse_ignores_padding():
    pred, target = torch.ones((1, 3, 4, 4, 4)), torch.zeros((1, 3, 4, 4, 4))
    mask = torch.zeros((1, 3, 4, 4, 4))
    mask[0, 0, 1, 1, 1] = 1.0
    assert float(train.masked_mse(pred, target, mask)) == 1.0
    assert float(train.masked_mse(pred, target, torch.zeros_like(mask))) == 0.0  # max(sum(mask), 1)


def test_capture_shapes_and_mask():
    ex, j_ex = _examples()
    assert ex.x.shape[:2] == (1, 11) and ex.y.shape == ex.mask.shape == (1, 3) + ex.x.shape[2:]
    n = _tiny(False).grid.res
    expected = sum(np.prod([k + (1 if i == a else 0) for i, k in enumerate(n)]) for a in range(3))
    assert int(ex.mask.sum()) == expected
    np.testing.assert_array_equal(_layout_j(ex.mask), np.asarray(j_ex.mask))
    np.testing.assert_array_equal(_layout_j(ex.x), np.asarray(j_ex.x))
    np.testing.assert_array_equal(_layout_j(ex.y), np.asarray(j_ex.y))


# -- the trainer


@pytest.mark.parametrize("lr,weight_decay", [(1e-4, 0.0), (1e-3, 1e-2)])
def test_make_trainer_matches_jax(lr, weight_decay):
    steps = 5
    ex, j_ex = _examples()
    params = random_flax_unet_params(4, seed=0)
    _, j_step = j_train.make_trainer(JUNet3D(width=4), lr, weight_decay)
    # JAX make_trainer's state from these parameters (its init draws them
    # with Flax's initialisers, eagerly: tens of seconds on the CPU)
    j_params = jax.tree.map(jnp.asarray, params)
    tx = optax.adamw(lr, weight_decay=weight_decay) if weight_decay else optax.adam(lr)
    jts = j_train.TrainState(j_params, tx.init(j_params), jnp.int32(0))
    model = UNet3D(width=4)
    init, train_step = train.make_trainer(model, lr, weight_decay)
    ts = init(torch.Generator().manual_seed(0), ex.x)
    model.load_state_dict(unet_state_dict_from_flax(params))
    assert isinstance(ts.optimizer, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    for _ in range(steps):
        jts, j_loss = j_step(jts, j_ex)
        ts, loss = train_step(ts, ex)
        assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert ts.step == steps
    want = unet_state_dict_from_flax(jax.device_get(jts.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-2 * lr * steps, err_msg=k)


def test_train_step_reduces_loss():
    ex, _ = _examples()
    model = UNet3D(width=4)
    init, train_step = train.make_trainer(model, lr=3e-4)
    ts = init(torch.Generator().manual_seed(0), ex.x)
    ts, loss0 = train_step(ts, ex)
    for _ in range(15):
        ts, loss = train_step(ts, ex)
    assert float(loss) < float(loss0)


def test_init_matches_flax_in_distribution():
    width = 8
    model = UNet3D(width=width)
    train.make_trainer(model)[0](torch.Generator().manual_seed(0), torch.zeros((1, 11, 16, 16, 16)))
    flax_sd = unet_state_dict_from_flax(jax.device_get(
        jax.jit(JUNet3D(width=width).init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 11)))))
    # the sample std of a truncated normal (cut at +-2) has a relative
    # standard error sqrt((kurtosis - 1) / (4 n))
    kurt = float(scipy.stats.truncnorm(-2, 2).stats(moments="k")) + 3.0
    z_port = []
    for key, w in model.state_dict().items():
        want = flax_sd[key]
        assert w.shape == want.shape
        if key.endswith(".bias"):
            assert not w.any() and not want.any()
            continue
        sigma = math.sqrt(1.0 / train.flax_fan_in(key.split(".")[0], w))
        assert float(w.abs().max()) <= 2 * sigma / train.TRUNC_STD, key
        rel_se = math.sqrt(2 * (kurt - 1) / (4 * w.numel()))
        assert abs(float(w.std()) / float(want.std()) - 1) <= INIT_SIGMAS * rel_se, key
        z_port.append((w.flatten() / sigma).numpy())
    # pooled over every kernel: lecun_normal's standardized law
    ks = scipy.stats.kstest(np.concatenate(z_port) * train.TRUNC_STD, scipy.stats.truncnorm(-2, 2).cdf)
    assert ks.pvalue > 1e-3, ks
    # a seed gives the same weights on every call
    again = UNet3D(width=width)
    train.lecun_init_(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), model.state_dict().values()))


def test_train_step_backward_runs_under_precise_flags():
    ex, _ = _examples()
    model = UNet3D(width=4)
    init, train_step = train.make_trainer(model)
    ts = init(torch.Generator().manual_seed(0), ex.x)
    seen = []

    def hook(grad):
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    model.enc1_1[0].weight.register_hook(hook)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        train_step(ts, ex)
        assert seen == [(True, False, False, False)]
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (False, True, True, True)  # restored
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def test_train_checkpoint_reads_in_both_packages(tmp_path):
    ex, _ = _examples()
    model = UNet3D(width=4)
    sd, losses = train.train(model, iter([ex, ex, ex]), num_steps=5, lr=1e-3, log_every=2)
    assert len(losses) == 3 and all(np.isfinite(losses))  # stops when the examples run out
    path = tmp_path / "unet.pt"
    torch.save({"net": sd}, path)
    back = load_reference_checkpoint(path)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    j_params = j_convert.load_torch_checkpoint(str(path))
    carried = unet_state_dict_from_flax(j_params)
    assert all(torch.equal(carried[k], v) for k, v in sd.items())


# -- FastUnpool and the pooling


def test_fast_unpool_matches_jax_and_conv_transpose():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 6, 5, 7)).astype(np.float32)  # channels-last, as test_unet.py's
    j_params = JFastUnpool(3).init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(JFastUnpool(3).apply(j_params, jnp.asarray(x)))
    kernel, bias = (np.array(j_params["params"][k]) for k in ("kernel", "bias"))
    m = FastUnpool(7, 3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(kernel[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))))
        m.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(_layout_t(x))
        got = m(xt)
        np.testing.assert_allclose(_layout_j(got), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), F.conv_transpose3d(xt, m.weight, m.bias, stride=2).numpy(), atol=1e-5)
    assert set(m.state_dict()) == {"weight", "bias"}


def test_fast_unpool_unet_matches_flax_and_conv_transpose_form():
    params = random_flax_unet_params(8, seed=0)
    fast, slow = UNet3D(width=8, fast_unpool=True).eval(), UNet3D(width=8).eval()
    for net in (fast, slow):
        net.load_state_dict(unet_state_dict_from_flax(params))
    assert isinstance(fast.unpool1, FastUnpool) and not isinstance(slow.unpool1, FastUnpool)
    x = np.random.default_rng(0).standard_normal((1, 11, 32, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got, ref = fast(torch.from_numpy(x)), slow(torch.from_numpy(x))
    want = np.asarray(JUNet3D(width=8, fast_unpool=True).apply(jax.tree.map(jnp.asarray, params),
                                                               jnp.asarray(_layout_j(x))))
    np.testing.assert_allclose(_layout_j(got), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 8, 6, 4), (2, 2, 4, 10, 6)])
def test_avg_pool_function(shape):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    assert torch.equal(AvgPool2.apply(x), F.avg_pool3d(x, 2))
    xd = x.double().requires_grad_(True)
    assert torch.autograd.gradcheck(AvgPool2.apply, (xd,))
    # the backward is ATen's (a scatter there) on the same gradient
    g = torch.randn(F.avg_pool3d(xd, 2).shape, dtype=torch.float64)
    want, = torch.autograd.grad(F.avg_pool3d(xd, 2), xd, g)
    got, = torch.autograd.grad(AvgPool2.apply(xd), xd, g)
    assert torch.equal(got, want)


def test_precise_flags_restore():
    before = torch.backends.cuda.matmul.allow_tf32
    with precise_flags():
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


# -- the engine's pairs


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def test_generate_training_data_matches_jax(monkeypatch):
    from python_fluid_simulation_tpu.engine.scenes import dam_break_scene as j_scene

    j_cfg = dataclasses.replace(_tiny(True), physics=dataclasses.replace(_tiny(True).physics, mu=0.5),
                                solver=JSolver(max_iter=200))
    cfg = dataclasses.replace(_tiny(False), physics=dataclasses.replace(_tiny(False).physics, mu=0.5),
                              solver=SolverConfig(max_iter=200))
    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        j_state = jax.device_get(j_scene(j_cfg))
        j_pairs = [jax.device_get(p) for p in j_train.generate_training_data(j_state, j_cfg, GEN_STEPS)]
    finally:
        jax.clear_caches()
    p, s = j_state.particles, j_state.solid
    start = state_from_numpy({"x": p.x, "v": p.v, "c": p.c, "m": p.m, "phi": s.phi, "sv": s.v, "rb": s.rb,
                              "t": j_state.t, "step_idx": j_state.step_idx}, device="cpu")
    pairs = list(train.generate_training_data(start, cfg, GEN_STEPS))
    assert len(pairs) == GEN_STEPS
    for ex, j_ex in zip(pairs, j_pairs):
        assert ex.x.shape[1] == 11 and ex.y.shape[1] == 3 and torch.isfinite(ex.y).all()
        np.testing.assert_array_equal(_layout_j(ex.mask), np.asarray(j_ex.mask))
        x, j_x = _layout_j(ex.x), np.asarray(j_ex.x)
        np.testing.assert_array_equal(x[..., 9], j_x[..., 9])
        np.testing.assert_allclose(x[..., :9], j_x[..., :9], atol=GEN_TOL["x"], rtol=0)
        np.testing.assert_allclose(x[..., 10], j_x[..., 10], atol=GEN_TOL["lvol"], rtol=0)
        np.testing.assert_allclose(_layout_j(ex.y), np.asarray(j_ex.y), atol=GEN_TOL["y"], rtol=0)
    assert float(pairs[-1].y.abs().max()) > 1.0


# -- the pipeline


def test_pipeline_capture_train_eval(tmp_path, capsys):
    out, dx = str(tmp_path), 0.05  # 12x20x12 cells
    where = dict(out=out, dx=dx, device="cpu")
    train_unet_prod.capture(3, **where)
    files = train_unet_prod.pair_files(out)
    assert [os.path.basename(f) for f in files] == [f"pair_{k:04d}.npz" for k in range(3)]
    z = np.load(files[1])
    assert sorted(z.files) == sorted(["gvx", "gvy", "gvz", "dvx", "dvy", "dvz", "lvol", "visc_iters"])
    assert z["gvx"].dtype == z["dvz"].dtype == np.float32 and z["lvol"].dtype == np.float16
    assert np.load(os.path.join(out, "sphi.npy")).shape == tuple(2 * n + 1 for n in (12, 20, 12))

    losses = train_unet_prod.train(1, lr=1e-3, width=4, **where)
    ckpt = train_unet_prod.ckpt_path(out, 4)
    assert len(losses) == 3 and os.path.exists(ckpt)
    assert np.load(os.path.join(out, "loss_curve.npy")).tolist() == losses
    # a resumed run starts from the checkpoint: its first loss is the
    # checkpoint's on the first pair of the same permutation
    cfg = train_unet_prod._cfg(dx)
    sphi = torch.from_numpy(np.load(os.path.join(out, "sphi.npy")))
    first = train_unet_prod.load_pair(files[np.random.default_rng(0).permutation(2)[0]], sphi, cfg)
    net = UNet3D(width=4, dtype=torch.bfloat16)
    net.load_state_dict(load_reference_checkpoint(ckpt))
    with torch.no_grad():
        want = float(train.masked_mse(net(first.x), first.y, first.mask))
    resumed = train_unet_prod.train(1, lr=1e-3, width=4, resume=True, steps_cap=2, **where)
    assert len(resumed) == 2 and resumed[0] == want
    assert "resumed from" in capsys.readouterr().out

    rec, series = train_unet_prod.evaluate(3, width=4, **where)
    assert len(series["iou"]) == len(series["apic_visc_iters"]) == len(series["warm_visc_iters"]) == 3
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f) == rec
    assert set(rec) == {"steps", "grid", "width", "iou_series_every_10", "iou_final", "iou_min",
                        "apic_visc_iters_mean", "warm_visc_iters_mean", "warm_iter_cut"}
    assert rec["grid"] == [12, 20, 12] and 0.0 <= rec["iou_min"] <= 1.0
    assert "bar iou_min >= 0.9:" in capsys.readouterr().out
