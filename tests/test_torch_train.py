"""The port's SSCD training (``vsc2022_torch.train``) against the JAX
package's (``vsc2022_tpu.train``), on the CPU, on the same numpy inputs.

* ``sscd_loss`` and its gradient with respect to both views, also with
  tied nearest neighbours (``amax`` splits a tie's gradient as
  ``jnp.max`` does);
* the training BatchNorm (``models/resnet.BatchNorm``) against
  ``flax.linen.BatchNorm(momentum=0.9)`` in train mode: output, running
  statistics and gradients; in eval mode it is ``nn.BatchNorm2d`` bit for
  bit;
* one SSCD step on JAX's ``TINY`` model (``tests/test_train.py``) from a
  converted init: the loss, every gradient and the batch statistics
  against ``jax.value_and_grad`` of JAX's step loss;
* the optimizer alone on given gradients against ``optax.adamw`` (optax's
  default decay and the CLI's) over three steps (Adam's first steps are
  about lr · sign(g), so a parameter update is not compared through the
  model's gradients);
* checkpoints crossing the packages both ways, and the Flax tree round
  trip through ``convert``;
* two gloo ranks equal to one process (the harness of
  ``tests/test_torch_multihost.py``);
* the CLI: JAX's command lines, the ``--synthetic`` frames equal to JAX's,
  the checkpoint loading into the port's inference CLI, and the card as
  the default device.

Tolerances (f32 on both sides; XLA-CPU's convolutions sum in another
order, and lie 5.7e-5 off a float64 evaluation of the TINY step's loss
where the port lies 6.7e-6 off): the loss within 2e-5 relative, each
gradient tensor within 5e-4 of its largest JAX value, the running
statistics within 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import optax

from vsc2022_torch import convert
from vsc2022_torch.models.resnet import BatchNorm
from vsc2022_torch.models.sscd import SSCDModel
from vsc2022_torch.train import create_train_state, make_train_step, sscd_loss
from vsc2022_torch.train.sscd_train import adamw
from vsc2022_torch.utils.checkpoint import load_variables, save_variables
from vsc2022_tpu.models.sscd import SSCDModel as JaxSSCD
from vsc2022_tpu.train import create_train_state as jax_create_train_state
from vsc2022_tpu.train import sscd_loss as jax_sscd_loss

TINY = dict(stage_sizes=(1, 1, 1, 1), stage_features=(4, 8, 8, 16), dims=16)
LOSS_RTOL = 2e-5
GRAD_TOL = 5e-4  # of each tensor's largest JAX gradient
STATS_ATOL = 1e-5


def l2n(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ---- the loss ---------------------------------------------------------------------


def _loss_and_grads_both(a, b):
    jl, (jga, jgb) = jax.value_and_grad(jax_sscd_loss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    pl = sscd_loss(ta, tb)
    pl.backward()
    return (float(jl), np.asarray(jga), np.asarray(jgb)), (float(pl.detach()), ta.grad.numpy(),
                                                           tb.grad.numpy())


@pytest.mark.parametrize("seed,b,d", [(0, 16, 8), (1, 8, 32), (2, 12, 16), (3, 5, 512)])
def test_sscd_loss_and_gradients_match_jax(seed, b, d):
    """Random unit descriptors (seed, [b, d]): the loss within 1e-6
    relative, both views' gradients within 1e-5 of their largest value."""
    rng = np.random.RandomState(seed)
    a = l2n(rng.randn(b, d)).astype(np.float32)
    v = l2n(rng.randn(b, d)).astype(np.float32)
    (jl, jga, jgb), (pl, pga, pgb) = _loss_and_grads_both(a, v)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    for got, want in ((pga, jga), (pgb, jgb)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_sscd_loss_splits_tied_neighbours_like_jax():
    """View A's rows repeat (rows 0-2 the same vector, rows 3-4 another),
    so KoLeo's max over each row has exact ties: amax splits the gradient
    among them as jnp.max does (torch.max(dim=) would send it to one)."""
    base = l2n(np.array([[1, 2, 0, 1], [0, 1, 3, 1], [2, 0, 1, 0]], np.float32))
    a = base[[0, 0, 0, 1, 1, 2]].astype(np.float32)
    b = l2n(np.arange(24, dtype=np.float32).reshape(6, 4) % 5 + 1).astype(np.float32)
    (jl, jga, jgb), (pl, pga, pgb) = _loss_and_grads_both(a, b)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(pga, jga, atol=1e-5 * np.abs(jga).max())
    np.testing.assert_allclose(pgb, jgb, atol=1e-5 * np.abs(jgb).max())


def test_aligned_views_lower_the_loss():
    rng = np.random.RandomState(0)
    a = torch.from_numpy(l2n(rng.randn(16, 8)).astype(np.float32))
    assert float(sscd_loss(a, a)) < float(sscd_loss(a, a.roll(1, 0)))


# ---- BatchNorm ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (8, 4, 4, 6)), (1, (3, 5, 7, 2)),
                                        (2, (4, 1, 1, 16))])
def test_batch_norm_trains_as_flax(seed, shape):
    """x [N, H, W, C] (NHWC for Flax, NCHW for the port) with a shift of 3
    (E[x²] − E[x]² then cancels), random scale, bias and running
    statistics: the output within 2e-5, the running mean and (biased)
    variance within 1e-6, the gradients of sum(y · w) with respect to x,
    scale and bias within 1e-4 of their largest value. (With two values a
    channel the normalized output is ±1 whatever x, so the gradient with
    respect to x is rounding alone: every case has at least four.)"""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 3.0).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def f(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": {"mean": mean0, "var": var0}},
                          x, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {"scale": scale, "bias": bias}, x)

    m = BatchNorm(c)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    tx = nchw(x).clone().requires_grad_()
    y = m.train()(tx)
    (y * nchw(w)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               atol=2e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(jstats["mean"]), atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(jstats["var"]), atol=1e-6)
    for got, want in ((tx.grad.permute(0, 2, 3, 1), jgx), (m.weight.grad, jgp["scale"]),
                      (m.bias.grad, jgp["bias"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert int(m.num_batches_tracked) == 1


def test_batch_norm_eval_is_batchnorm2d_bit_for_bit():
    """In eval mode the training BatchNorm is nn.BatchNorm2d, bit for bit,
    with the same parameter and buffer names (every inference path)."""
    rng = np.random.RandomState(4)
    ref = torch.nn.BatchNorm2d(6, eps=1e-5)
    with torch.no_grad():
        for t in (ref.weight, ref.bias, ref.running_mean):
            t.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
        ref.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    m = BatchNorm(6)
    m.load_state_dict(ref.state_dict())
    assert list(m.state_dict()) == list(ref.state_dict())
    x = torch.from_numpy(rng.randn(3, 6, 5, 4).astype(np.float32))
    assert torch.equal(m.eval()(x), ref.eval()(x))
    model = SSCDModel(**TINY)
    assert all(type(mod) is BatchNorm for mod in model.modules()
               if isinstance(mod, torch.nn.BatchNorm2d))


# ---- one step against JAX -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tiny_step():
    """JAX's TINY SSCD model at PRNGKey(0), two 8 x 32 x 32 views (seed 0),
    and value_and_grad of JAX's step loss (make_train_step's loss_fn)."""
    model = JaxSSCD(**TINY)
    state = jax_create_train_state(jax.random.PRNGKey(0), model, optax.adamw(1e-3),
                                   input_shape=(1, 32, 32, 3))
    rng = np.random.RandomState(0)
    va = rng.rand(8, 32, 32, 3).astype(np.float32)
    vb = rng.rand(8, 32, 32, 3).astype(np.float32)

    def loss_fn(params, batch_stats, view_a, view_b):
        da, upd = model.apply({"params": params, "batch_stats": batch_stats}, view_a,
                              train=True, mutable=["batch_stats"])
        db, upd = model.apply({"params": params, "batch_stats": upd["batch_stats"]},
                              view_b, train=True, mutable=["batch_stats"])

        def n(x):
            return x / jnp.clip(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

        return jax_sscd_loss(n(da), n(db)), upd["batch_stats"]

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.batch_stats, jnp.asarray(va), jnp.asarray(vb))
    variables = tree_np({"params": state.params, "batch_stats": state.batch_stats})
    return dict(model=model, variables=variables, va=va, vb=vb, loss=float(loss),
                stats=tree_np(stats), grads=tree_np(grads))


def test_sscd_step_matches_jax_on_a_converted_init(jax_tiny_step):
    j = jax_tiny_step
    model = SSCDModel(**TINY)
    state = create_train_state(model, 1e-3, variables=j["variables"], device="cpu")
    step = make_train_step(model)
    state, loss = step(state, {"view_a": nchw(j["va"]), "view_b": nchw(j["vb"])})
    assert state.step == 1
    np.testing.assert_allclose(float(loss), j["loss"], rtol=LOSS_RTOL)
    want = convert.sscd_from_jax({"params": j["grads"], "batch_stats": j["stats"]})
    for name, p in model.named_parameters():
        scale = np.abs(want[name]).max()
        assert np.abs(p.grad.numpy() - want[name]).max() <= GRAD_TOL * scale, name
    stats = convert.sscd_from_jax({"params": j["variables"]["params"],
                                   "batch_stats": j["stats"]})
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name], atol=STATS_ATOL,
                                       err_msg=name)
        elif name.endswith("num_batches_tracked"):
            assert int(buf) == 2  # view A, then view B


def test_step_moves_the_parameters_and_needs_its_own_model(jax_tiny_step):
    j = jax_tiny_step
    model = SSCDModel(**TINY)
    state = create_train_state(model, 1e-3, variables=j["variables"], device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    state, _ = make_train_step(model)(state, {"view_a": j["va"].transpose(0, 3, 1, 2).copy(),
                                              "view_b": j["vb"].transpose(0, 3, 1, 2).copy()})
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="another model"):
        make_train_step(SSCDModel(**TINY))(state, {})


# ---- the optimizers on given gradients ----------------------------------------------


def _given_gradients(seed, shapes, steps):
    rng = np.random.RandomState(seed)
    params = {f"p{i}": rng.randn(*s).astype(np.float32) for i, s in enumerate(shapes)}
    # Some gradients near zero, where Adam's first step is lr · g / (|g| + eps).
    grads = [{k: (rng.randn(*v.shape) * rng.choice([1e-9, 1e-3, 1.0], v.shape))
              .astype(np.float32) for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _torch_run(opt_fn, params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = opt_fn(list(ps.values()))
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in ps.items()}


def _optax_run(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = tx.init(p)
    for g in grads:
        u, s = tx.update({k: jnp.asarray(v) for k, v in g.items()}, s, p)
        p = optax.apply_updates(p, u)
    return tree_np(p)


@pytest.mark.parametrize("lr,wd", [(1e-3, 1e-4), (1e-4, 1e-2), (3e-3, 0.0)])
def test_adamw_is_optax_adamw(lr, wd):
    """Three steps on given gradients (seed 5; shapes [7, 3], [11], [2, 2,
    3]): the parameters within 1e-6 of optax's (decay scaled by the
    learning rate, every leaf decayed)."""
    params, grads = _given_gradients(5, [(7, 3), (11,), (2, 2, 3)], 3)
    got = _torch_run(lambda ps: adamw(ps, lr, wd), params, grads)
    want = _optax_run(optax.adamw(lr, weight_decay=wd), params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


def test_default_decay_is_optax_default():
    params, grads = _given_gradients(6, [(5, 4)], 2)
    got = _torch_run(lambda ps: adamw(ps, 1e-3), params, grads)
    want = _optax_run(optax.adamw(1e-3), params, grads)
    np.testing.assert_allclose(got["p0"], want["p0"], atol=1e-6, rtol=0)


# ---- checkpoints across the packages ------------------------------------------------


def _assert_same_tree(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("kw", [TINY, dict(stage_sizes=(2, 1, 2, 1),
                                           stage_features=(4, 4, 8, 8), dims=8)])
def test_flax_tree_round_trips_exactly(kw):
    """A Flax SSCDModel tree → sscd_from_jax → sscd_to_jax is the same tree,
    byte for byte (random statistics, so every leaf is distinct)."""
    model = JaxSSCD(**kw)
    variables = tree_np(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.RandomState(3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables["batch_stats"])
    _assert_same_tree(convert.sscd_to_jax(convert.sscd_from_jax(variables)), variables)


def test_folded_trunk_round_trips():
    from vsc2022_torch.models.fold import fold_batchnorm

    model = SSCDModel(**TINY)
    torch.manual_seed(0)
    state = fold_batchnorm({k: v.numpy() for k, v in model.state_dict().items()})
    back = convert.sscd_from_jax(convert.sscd_to_jax(state))
    assert sorted(back) == sorted(state)
    for k in state:
        assert np.array_equal(back[k], state[k]), k


def _trained_port_model(j, steps=2):
    model = SSCDModel(**TINY)
    state = create_train_state(model, 1e-3, variables=j["variables"], device="cpu")
    step = make_train_step(model)
    for _ in range(steps):
        state, _ = step(state, {"view_a": nchw(j["va"]), "view_b": nchw(j["vb"])})
    return model.eval()


def test_port_checkpoint_loads_in_jax(jax_tiny_step, tmp_path):
    """The port trains two steps and writes sscd_to_jax as an npz; JAX's
    SSCDModel.apply (eval) on that checkpoint equals the port's eval
    forward within 1e-5 of the largest descriptor value."""
    j = jax_tiny_step
    model = _trained_port_model(j)
    path = str(tmp_path / "port.npz")
    save_variables(path, convert.sscd_to_jax(model.state_dict()))
    from vsc2022_tpu.utils.checkpoint import load_variables as jax_load

    want = np.asarray(j["model"].apply(jax_load(path), jnp.asarray(j["va"])))
    with torch.no_grad():
        got = model(nchw(j["va"])).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_params_alone_keep_the_init_statistics(jax_tiny_step):
    """A tree without "batch_stats" (params alone, as the JAX CLI accepts):
    the parameters load, the BatchNorm statistics stay the seeded init's
    (mean 0, variance 1)."""
    j = jax_tiny_step
    model = SSCDModel(**TINY)
    create_train_state(model, variables={"params": j["variables"]["params"]}, device="cpu")
    want = convert.sscd_from_jax(j["variables"])
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[name]), name
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            assert not b.any(), name
        elif name.endswith("running_var"):
            assert bool((b == 1).all()), name


def test_jax_checkpoint_loads_in_port(jax_tiny_step, tmp_path):
    """JAX's step (the JAX package's make_train_step) writes its
    {params, batch_stats} as the JAX CLI does; the port's
    create_train_state and inference build_model load it, and their eval
    forwards equal JAX's within 1e-5 of the largest value."""
    from vsc2022_tpu.train import make_train_step as jax_make_train_step
    from vsc2022_tpu.utils.checkpoint import save_variables as jax_save

    j = jax_tiny_step
    tx = optax.adamw(1e-3)
    state = jax_create_train_state(jax.random.PRNGKey(0), j["model"], tx,
                                   input_shape=(1, 32, 32, 3))
    state, _ = jax.jit(jax_make_train_step(j["model"], tx))(
        state, {"view_a": jnp.asarray(j["va"]), "view_b": jnp.asarray(j["vb"])})
    path = str(tmp_path / "jax.npz")
    jax_save(path, {"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats)})
    want = np.asarray(j["model"].apply({"params": state.params,
                                        "batch_stats": state.batch_stats},
                                       jnp.asarray(j["vb"])))
    model = SSCDModel(**TINY)
    create_train_state(model, variables=load_variables(path), device="cpu")
    with torch.no_grad():
        got = model.eval()(nchw(j["vb"])).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---- two ranks equal one process ----------------------------------------------------

DP_WORKER = r"""
from vsc2022_torch.models.sscd import SSCDModel
from vsc2022_torch.parallel.mesh import train_mesh
from vsc2022_torch.train import create_train_state, make_train_step
TINY = dict(stage_sizes=(1, 1, 1, 1), stage_features=(4, 8, 8, 16), dims=16)
rng = np.random.RandomState(11)
va = rng.rand(8, 3, 32, 32).astype(np.float32)
vb = rng.rand(8, 3, 32, 32).astype(np.float32)
mesh = train_mesh(device="cpu")
assert mesh.size == 2 and mesh.spans_processes and mesh.axis_names == ("data",), mesh
model = SSCDModel(**TINY)
state = create_train_state(model, 1e-3, seed=4, device="cpu")
step = make_train_step(model, mesh)
rows = slice(4 * RANK, 4 * RANK + 4)
state, loss = step(state, {"view_a": va[rows], "view_b": vb[rows]})
np.savez(os.path.join(OUT, f"sscd{RANK}.npz"), loss=loss.numpy(),
         **{"grad/" + n: p.grad.numpy() for n, p in model.named_parameters()},
         **{"param/" + n: p.detach().numpy() for n, p in model.named_parameters()},
         **{"buf/" + n: b.numpy() for n, b in model.named_buffers()})
"""


def test_two_ranks_equal_one_process(tmp_path):
    """A TINY SSCD step over two gloo ranks (4 of 8 frames each, seed 11,
    32 x 32) against one process on all 8: both ranks hold the same loss,
    gradients, statistics and parameters bit for bit; against one process
    the loss within 1e-6 relative, the gradients (not twice them) within
    1e-4 of each tensor's largest value, the statistics within 1e-6."""
    from test_torch_multihost import _run_ranks

    _run_ranks(DP_WORKER, tmp_path)
    ranks = [dict(np.load(tmp_path / f"sscd{r}.npz")) for r in range(2)]
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    rng = np.random.RandomState(11)
    va = rng.rand(8, 3, 32, 32).astype(np.float32)
    vb = rng.rand(8, 3, 32, 32).astype(np.float32)
    model = SSCDModel(**TINY)
    state = create_train_state(model, 1e-3, seed=4, device="cpu")
    state, loss = make_train_step(model)(state, {"view_a": va, "view_b": vb})
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
    for n, p in model.named_parameters():
        want = p.grad.numpy()
        assert np.abs(got["grad/" + n] - want).max() <= 1e-4 * np.abs(want).max(), n
    for n, b in model.named_buffers():
        np.testing.assert_allclose(got["buf/" + n], b.numpy(), atol=1e-6, err_msg=n)


def test_a_mesh_of_one_process_devices_is_refused():
    from vsc2022_torch.parallel.mesh import Mesh, train_mesh

    model = SSCDModel(**TINY)
    with pytest.raises(ValueError, match="one rank a card"):
        make_train_step(model, Mesh(["cpu"] * 2))
    mesh = train_mesh(device="cpu")
    assert mesh.size == 1 and mesh.axis_names == ("data",)
    make_train_step(model, mesh)  # one entry: the plain step
    with pytest.raises(ValueError, match="one device a rank"):
        train_mesh(2, device="cpu")


# ---- the CLI --------------------------------------------------------------------------

JAX_COMMAND_LINES = [
    ["--synthetic", "256", "--steps", "10", "--batch_size", "64", "--image_size", "224",
     "--checkpoint_out", "out/sscd.npz"],
    ["--dataset_path", "videos", "--fps", "2", "--ffmpeg_path", "/usr/bin/ffmpeg",
     "--init_checkpoint", "in.npz", "--learning_rate", "3e-4", "--weight_decay", "0.05",
     "--checkpoint_out", "o.npz", "--checkpoint_every", "50", "--seed", "3",
     "--log_every", "1"],
    ["--objective", "dns_distill", "--student", "cg", "--synthetic", "8",
     "--frames_per_video", "6", "--checkpoint_out", "cg.npz"],
    ["--objective", "dns_distill", "--student", "fg", "--fg_type", "bin",
     "--distill_pairs", "pairs.npz", "--batch_size", "16", "--checkpoint_out", "bin.npz"],
]


@pytest.mark.parametrize("argv", JAX_COMMAND_LINES, ids=range(len(JAX_COMMAND_LINES)))
def test_parser_takes_jax_command_lines(argv):
    """JAX's 19 flags parse to the same values; the port adds --device."""
    from vsc2022_torch.train import cli
    from vsc2022_tpu.train import cli as jax_cli

    got = vars(cli.parser.parse_args(argv))
    want = vars(jax_cli.parser.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert len(want) == 19
    assert cli.parser.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_synthetic_frames_equal_jax():
    """--synthetic 12 at 16 px, batch 5, seed 7: the first four batches equal
    the JAX CLI's byte for byte; a rank's batch is its slice of them."""
    from vsc2022_torch.train import cli
    from vsc2022_tpu.train import cli as jax_cli

    argv = ["--synthetic", "12", "--image_size", "16", "--batch_size", "6", "--seed", "7",
            "--checkpoint_out", "x.npz"]
    mine, theirs = cli.frame_source(cli.parser.parse_args(argv)), jax_cli.frame_source(
        jax_cli.parser.parse_args(argv))
    rank1 = cli.frame_source(cli.parser.parse_args(argv), rank=1, world=2)
    for _ in range(4):
        a, b = next(mine), next(theirs)
        assert a.dtype == b.dtype == np.uint8 and a.shape == (6, 16, 16, 3)
        assert np.array_equal(a, b)
        assert np.array_equal(next(rank1), b[3:])


def test_cli_checkpoint_loads_into_the_inference_cli(tmp_path):
    """The port's CLI (ResNet-50 SSCD, --synthetic 4, two steps of batch 2 at
    32 px, on the CPU) writes a JAX-layout checkpoint; the inference CLI's
    build_model(--checkpoint_path) equals the trained model's eval forward
    bit for bit (same CPU arithmetic), and the losses are finite."""
    from vsc2022_torch.inference import cli as inference_cli
    from vsc2022_torch.train import cli

    out = str(tmp_path / "sscd.npz")
    summary = cli.main(cli.parser.parse_args([
        "--synthetic", "4", "--steps", "2", "--batch_size", "2", "--image_size", "32",
        "--checkpoint_out", out, "--log_every", "1", "--device", "cpu"]))
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"]).all()
    assert summary["steady_frames_per_s"] > 0 and summary["state"].step == 2
    tree = load_variables(out)
    assert sorted(tree) == ["batch_stats", "params"]
    args = inference_cli.parser.parse_args([
        "--baseline", "sscd", "--checkpoint_path", out, "--dataset_path", "-",
        "--output_file", "-", "--device", "cpu"])
    loaded = inference_cli.build_model(args)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(loaded(x), summary["state"].model.eval()(x))


def test_training_runs_on_the_card_by_default():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from vsc2022_torch.train import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(SSCDModel(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(cli.parser.parse_args(["--synthetic", "2", "--steps", "1",
                                        "--batch_size", "2", "--image_size", "32",
                                        "--checkpoint_out", os.devnull]))
