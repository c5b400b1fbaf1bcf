"""The port's DnS student distillation (``vsc2022_torch.train.dns_distill``
and ``--objective dns_distill`` of its CLI) against the JAX package's, on
the CPU, on the same numpy inputs.

Inputs are JAX's test batch (``tests/test_train.py``): seed 8, six pairs
of 4 frames x 9 regions x 3840, half of them noisy copies, the teacher's
similarity the frame chamfer. Students start from JAX's ``PRNGKey(0)``
init carried across with ``convert.dns_student_from_jax``.

Tolerances (f32; the products sum in another order): pair similarities
within 1e-6, the loss within 1e-6, each gradient tensor within 1e-5 of
its largest JAX value; integer-valued chamfer inputs (exact products, tied
maxima) exactly, their gradients within 1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vsc2022_torch import convert
from vsc2022_torch.train import dns_distill as port
from vsc2022_torch.utils.checkpoint import load_variables
from vsc2022_tpu.train import dns_distill as jd

STUDENTS = [("fg", "att", 0.0), ("fg", "bin", 0.1), ("fg", "bin", 0.0), ("cg", "att", 0.0)]
IDS = ["fg_att", "fg_bin_quant", "fg_bin", "cg"]


def make_batch(rng, b=6, t=4):
    """JAX's test batch (TestDnSDistillation.make_batch), as numpy."""
    def regions(n):
        x = rng.randn(n, t, 9, 3840).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, r = regions(b), regions(b)
    for i in range(0, b, 2):
        r[i] = q[i] + 0.05 * rng.randn(*q[i].shape).astype(np.float32)
        r[i] /= np.linalg.norm(r[i], axis=-1, keepdims=True)
    teacher = np.asarray([float(jd._frame_chamfer(jnp.asarray(q[i]), jnp.asarray(r[i])))
                          for i in range(b)], dtype=np.float32)
    return {"q_regions": q, "r_regions": r, "teacher_sim": teacher}


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.RandomState(8))


def jax_student(student, fg_type, lr=3e-3):
    module = jd.build_student_module(student, fg_type)
    tx = optax.adam(lr)
    return module, tx, jd.create_distill_state(jax.random.PRNGKey(0), module, tx)


def port_student(student, fg_type, params, lr=3e-3):
    module = port.build_student_module(student, fg_type)
    variables = jax.tree_util.tree_map(np.asarray, params)
    return module, port.create_distill_state(module, lr, variables=variables, device="cpu")


# ---- the similarity and the loss ---------------------------------------------------


def test_frame_chamfer_matches_jax(batch):
    q, r = batch["q_regions"], batch["r_regions"]
    got = port._frame_chamfer(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, batch["teacher_sim"], atol=1e-6, rtol=0)


def test_frame_chamfer_ties_split_as_jax():
    """Integers in {-1, 0, 1} (exact products, many tied maxima over
    frames and regions; 4 frames and 4 regions, so the means are exact):
    the value equals JAX's exactly, and the gradients with respect to both
    sides within 1e-6 relative (amax and jnp.max split a tie evenly; a
    three-way split rounds)."""
    rng = np.random.RandomState(4)
    q = rng.randint(-1, 2, size=(3, 4, 4, 6)).astype(np.float32)
    r = rng.randint(-1, 2, size=(3, 4, 4, 6)).astype(np.float32)
    jv, (jgq, jgr) = jax.value_and_grad(
        lambda a, b: jnp.sum(jax.vmap(jd._frame_chamfer)(a, b) * jnp.arange(1.0, 4.0)),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(r))
    tq, tr = torch.from_numpy(q).requires_grad_(), torch.from_numpy(r).requires_grad_()
    v = (port._frame_chamfer(tq, tr) * torch.arange(1.0, 4.0)).sum()
    v.backward()
    assert float(v.detach()) == float(jv)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), rtol=1e-6, atol=0)
    assert np.count_nonzero(tq.grad.numpy() % 1.0) > 0  # fractional: ties were split


@pytest.mark.parametrize("student,fg_type,qw", STUDENTS, ids=IDS)
def test_pair_similarity_loss_and_gradients_match_jax(batch, student, fg_type, qw):
    """student_pair_similarity, the distill loss (with and without the
    quantization term) and every parameter's gradient after one port step
    against jax.value_and_grad of JAX's step loss (make_distill_step's
    loss_fn)."""
    module, _, state = jax_student(student, fg_type)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        eq = jd._encode_batch(module, params, jb["q_regions"])
        er = jd._encode_batch(module, params, jb["r_regions"])
        sims = jd._encoded_pair_similarity(eq, er, student)
        loss = jnp.mean(jnp.abs(sims - jb["teacher_sim"]))
        if qw > 0.0:
            loss = loss + qw * 0.5 * (jnp.mean(jnp.abs(jnp.abs(eq) - 1.0))
                                      + jnp.mean(jnp.abs(jnp.abs(er) - 1.0)))
        return loss

    jloss, jgrads = jax.value_and_grad(loss_fn)(state.params)
    jsims = jd.student_pair_similarity(module, state.params, jb["q_regions"],
                                       jb["r_regions"], student)
    pm, pstate = port_student(student, fg_type, state.params)
    with torch.no_grad():
        sims = port.student_pair_similarity(pm, torch.from_numpy(batch["q_regions"]),
                                            torch.from_numpy(batch["r_regions"]), student)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=1e-6, rtol=0)
    pstate, loss = port.make_distill_step(pm, student, qw)(pstate, batch)
    assert pstate.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-6, rtol=0)
    want = convert.dns_student_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                        student, fg_type)
    assert sorted(want) == sorted(n for n, _ in pm.named_parameters())
    for name, p in pm.named_parameters():
        assert np.abs(p.grad.numpy() - want[name]).max() <= 1e-5 * np.abs(want[name]).max(), name


def test_quantization_term_is_the_only_difference(batch):
    """fg bin with and without the term: the losses differ by qw x the mean
    | |code| − 1 | of both sides (halved)."""
    module = port.build_student_module("fg", "bin")
    port.create_distill_state(module, seed=0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        plain = port.distill_loss(module, tb, "fg")
        quant = port.distill_loss(module, tb, "fg", quantization_weight=0.1)
        eq = port._encode(module, tb["q_regions"])
        er = port._encode(module, tb["r_regions"])
        term = 0.5 * ((eq.abs() - 1).abs().mean() + (er.abs() - 1).abs().mean())
    np.testing.assert_allclose(float(quant - plain), 0.1 * float(term), rtol=1e-5)


@pytest.mark.parametrize("student,fg_type,qw", [STUDENTS[0], STUDENTS[1], STUDENTS[3]],
                         ids=["fg_att", "fg_bin", "cg"])
def test_loss_decreases(batch, student, fg_type, qw):
    """As tests/test_train.py::TestDnSDistillation::test_loss_decreases: 12
    Adam steps (lr 3e-3) on the fixed batch from JAX's init; the last loss
    under 0.75 of the larger of the first two."""
    _, _, state = jax_student(student, fg_type)
    pm, pstate = port_student(student, fg_type, state.params)
    step = port.make_distill_step(pm, student, quantization_weight=qw)
    losses = []
    for _ in range(12):
        pstate, loss = step(pstate, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < max(losses[:2]) * 0.75, losses


def test_adam_is_optax_adam():
    """Three steps on given gradients (seed 9, some near zero): the
    parameters within 1e-6 of optax.adam's."""
    rng = np.random.RandomState(9)
    p0 = rng.randn(13, 5).astype(np.float32)
    grads = [(rng.randn(13, 5) * rng.choice([1e-9, 1e-3, 1.0], (13, 5))).astype(np.float32)
             for _ in range(3)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = port.adam([p], 2e-3)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
    tx = optax.adam(2e-3)
    jp = jnp.asarray(p0)
    s = tx.init(jp)
    for g in grads:
        u, s = tx.update(jnp.asarray(g), s, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)


# ---- checkpoints across the packages ------------------------------------------------


@pytest.mark.parametrize("student,fg_type", [("fg", "att"), ("fg", "bin"), ("cg", "att")])
def test_student_tree_round_trips_exactly(student, fg_type):
    _, _, state = jax_student(student, fg_type)
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    back = convert.dns_student_to_jax(convert.dns_student_from_jax(tree, student, fg_type),
                                      student, fg_type)
    flat = jax.tree_util.tree_leaves_with_path
    a, b = dict(flat(tree)), dict(flat(back))
    assert sorted(map(str, a)) == sorted(map(str, b))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("student,fg_type", [("fg", "att"), ("fg", "bin"), ("cg", "att")])
def test_cli_checkpoints_cross_the_packages(tmp_path, student, fg_type):
    """Each CLI distils 2 steps (--synthetic 8, batch 4) and writes its npz;
    each package's DnSStudent loads the other's (dns_index's
    --checkpoint_path route in the port), and the two packages' index_video
    on one checkpoint agree within 1e-5. The port also fine-tunes from
    JAX's checkpoint (--init_checkpoint)."""
    from vsc2022_torch.baseline import dns_index
    from vsc2022_torch.train import cli
    from vsc2022_tpu.models.dns import DnSStudent as JaxStudent
    from vsc2022_tpu.train import cli as jax_cli
    from vsc2022_tpu.utils.checkpoint import load_variables as jax_load

    argv = ["--objective", "dns_distill", "--student", student, "--fg_type", fg_type,
            "--synthetic", "8", "--steps", "2", "--batch_size", "4"]
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    summary = cli.main(cli.parser.parse_args(argv + ["--checkpoint_out", mine,
                                                     "--device", "cpu"]))
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"]).all()
    jax_cli.main(jax_cli.parser.parse_args(argv + ["--checkpoint_out", theirs]))
    regions = np.random.RandomState(13).randn(3, 9 * 3840).astype(np.float32)
    for path in (mine, theirs):
        args = dns_index.parser.parse_args([
            "--query_features", "q.npz", "--ref_features", "r.npz", "--output_path", "o",
            "--student", student, "--fg_type", fg_type, "--checkpoint_path", path,
            "--device", "cpu"])
        got = dns_index._build_student(args, torch.device("cpu")).index_video(regions)
        want = JaxStudent(student, fg_type if student == "fg" else None,
                          params=jax_load(path)).index_video(regions)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    tuned = str(tmp_path / "tuned.npz")
    cli.main(cli.parser.parse_args(argv + ["--checkpoint_out", tuned, "--device", "cpu",
                                           "--init_checkpoint", theirs, "--steps", "1"]))
    assert sorted(load_variables(tuned)["params"]) == sorted(jax_load(theirs)["params"])


def test_synthetic_pairs_equal_jax():
    """--synthetic 6 pairs of 3 frames, batch 4, seed 2: the regions and the
    sampled batches equal the JAX CLI's byte for byte, the teacher's
    similarities within 1e-6; a rank's batch is its slice."""
    from vsc2022_torch.train import cli
    from vsc2022_tpu.train import cli as jax_cli

    argv = ["--objective", "dns_distill", "--synthetic", "6", "--frames_per_video", "3",
            "--batch_size", "4", "--seed", "2", "--checkpoint_out", "x.npz"]
    mine = cli.distill_batches(cli.parser.parse_args(argv))
    theirs = jax_cli.distill_batches(jax_cli.parser.parse_args(argv))
    rank1 = cli.distill_batches(cli.parser.parse_args(argv), rank=1, world=2)
    for _ in range(3):
        a, b, half = next(mine), next(theirs), next(rank1)
        for k in ("q_regions", "r_regions"):
            assert np.array_equal(a[k], np.asarray(b[k])), k
            assert np.array_equal(half[k], a[k][2:]), k
        np.testing.assert_allclose(a["teacher_sim"], b["teacher_sim"], atol=1e-6, rtol=0)


def test_distill_pairs_file_is_read(tmp_path, batch):
    from vsc2022_torch.train import cli

    path = str(tmp_path / "pairs.npz")
    np.savez(path, **batch)
    src = cli.distill_batches(cli.parser.parse_args([
        "--objective", "dns_distill", "--distill_pairs", path, "--batch_size", "3",
        "--checkpoint_out", "x.npz"]))
    idx = np.random.RandomState(0).randint(0, 6, size=3)
    got = next(src)
    for k, v in batch.items():
        assert np.array_equal(got[k], v[idx]), k


def test_distill_cli_needs_data():
    from vsc2022_torch.train import cli

    with pytest.raises(Exception, match="--distill_pairs or --synthetic"):
        cli.main(cli.parser.parse_args(["--objective", "dns_distill",
                                        "--checkpoint_out", "x.npz", "--device", "cpu"]))
    with pytest.raises(Exception, match="--dataset_path or --synthetic"):
        cli.main(cli.parser.parse_args(["--checkpoint_out", "x.npz", "--device", "cpu"]))


# ---- two ranks equal one process -----------------------------------------------------

DP_WORKER = r"""
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from vsc2022_torch.parallel.mesh import train_mesh
from vsc2022_torch.train import dns_distill as port
rng = np.random.RandomState(21)
q = rng.randn(8, 3, 9, 3840).astype(np.float32)
r = rng.randn(8, 3, 9, 3840).astype(np.float32)
t = rng.rand(8).astype(np.float32)
mesh = train_mesh(device="cpu")
for student, fg_type, qw in (("fg", "bin", 0.1), ("cg", "att", 0.0)):
    module = port.build_student_module(student, fg_type)
    state = port.create_distill_state(module, 1e-3, seed=5, device="cpu")
    step = port.make_distill_step(module, student, qw, mesh=mesh)
    rows = slice(4 * RANK, 4 * RANK + 4)
    state, loss = step(state, {"q_regions": q[rows], "r_regions": r[rows],
                               "teacher_sim": t[rows]})
    np.savez(os.path.join(OUT, f"{student}{RANK}.npz"), loss=loss.numpy(),
             **{"grad/" + n: p.grad.numpy() for n, p in module.named_parameters()})
"""


def test_two_ranks_equal_one_process(tmp_path):
    """fg bin (with the quantization term) and cg over two gloo ranks (4 of
    8 pairs each, seed 21) against one process: both ranks hold the same
    loss and gradients bit for bit; against one process the loss within
    1e-6, the gradients (summed, not twice them) within 1e-4 of their
    largest value (the reduction's weight gradient sums 216 rows as two
    halves: 4.9e-5 read); fg bin's rotation within 1e-3 (the quantization
    term's |·| kinks at 0 and ±1, and a code computed in a product of 4 or
    of 8 pairs' rows may round to either side of one: 2.9e-4 read)."""
    from test_torch_multihost import _run_ranks

    _run_ranks(DP_WORKER, tmp_path)
    rng = np.random.RandomState(21)
    q = rng.randn(8, 3, 9, 3840).astype(np.float32)
    r = rng.randn(8, 3, 9, 3840).astype(np.float32)
    t = rng.rand(8).astype(np.float32)
    for student, fg_type, qw in (("fg", "bin", 0.1), ("cg", "att", 0.0)):
        ranks = [dict(np.load(tmp_path / f"{student}{k}.npz")) for k in range(2)]
        for k in ranks[0]:
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
        module = port.build_student_module(student, fg_type)
        state = port.create_distill_state(module, 1e-3, seed=5, device="cpu")
        state, loss = port.make_distill_step(module, student, qw)(
            state, {"q_regions": q, "r_regions": r, "teacher_sim": t})
        np.testing.assert_allclose(ranks[0]["loss"], float(loss), atol=1e-6, rtol=0)
        for n, p in module.named_parameters():
            want = p.grad.numpy()
            tol = 1e-3 if n == "binarization.W" else 1e-4
            assert np.abs(ranks[0]["grad/" + n] - want).max() <= tol * np.abs(want).max(), n


SPAWN = r"""
import sys
from vsc2022_torch.train import cli
args = cli.parser.parse_args(sys.argv[1:])
cli._spawn_ranks(args, ["cpu", "cpu"])
"""


def test_cli_ranks_equal_one_process(tmp_path):
    """The CLI's data-parallel route (``_spawn_ranks``: one spawned rank a
    device, here two on the CPU over gloo) writes, from rank 0, the
    checkpoint of a one-process run within 2·lr·steps (Adam moves a
    parameter by about lr a step, and rounding may part two runs' signs
    where a gradient is near 0)."""
    import subprocess
    import sys

    argv = ["--objective", "dns_distill", "--student", "fg", "--fg_type", "att",
            "--synthetic", "8", "--steps", "2", "--batch_size", "4", "--learning_rate",
            "1e-3"]
    from test_torch_multihost import REPO, _env

    ranked = str(tmp_path / "ranked.npz")
    out = subprocess.run([sys.executable, "-c", SPAWN, *argv, "--checkpoint_out", ranked,
                          "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step 2/2 loss" in out.stderr
    from vsc2022_torch.train import cli

    single = str(tmp_path / "single.npz")
    cli.main(cli.parser.parse_args(argv + ["--checkpoint_out", single, "--device", "cpu"]))
    a, b = load_variables(ranked)["params"], load_variables(single)["params"]
    for leaf in jax.tree_util.tree_leaves_with_path(a):
        path, got = leaf
        want = b
        for p in path:
            want = want[p.key]
        np.testing.assert_allclose(got, want, atol=2 * 1e-3 * 2 + 1e-6, rtol=0,
                                   err_msg=str(path))
    assert os.path.getsize(ranked) > 0
