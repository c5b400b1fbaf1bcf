"""The port's multi-host pods on the CPU: two ranks in a gloo process
group, each a subprocess on a free localhost port, against the JAX
package's single-device searcher and the port's one-process runs.

The counterparts of ``tests/test_multihost_smoke.py`` (JAX's two-process
tests, marked slow there), with the same inputs (numpy seeds and shapes):

* the corpus-sharded search over two ranks × ``Mesh(["cpu"] * 4)`` (eight
  shards), streaming and forced pooled, equal to JAX's single-device
  ``SimilaritySearcher`` on integer inputs in every dtype and metric, the
  same on both ranks, also through ``append_rows`` and ``keep_rows``
  (rows move between the ranks);
* the inference CLI as a two-rank job (``--coordinator``): rank 0 owns
  vid0 and vid2, and the merged shards equal a one-process run bit for
  bit;
* the serving pod (``serve --sharded --coordinator ... --control ...``):
  the request lifecycle byte for byte with a one-process server, the
  follower's death turned into error responses, and the DnS two-stage
  pod;
* the collectives' ragged ``all_gather``, ``psum``, ``pmax`` and
  ``exchange``, the backend rule and the flags JAX rejects.

Each child runs one CPU thread and has its own ``communicate`` timeout, so
a hung rank fails its test instead of the whole run.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTION_ENV = "VSC2022_TORCH_COLLECTION"
TIMEOUT = 120  # seconds a child may take


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


PRELUDE = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from vsc2022_torch.parallel.mesh import initialize_distributed, pod_mesh
RANK, PORT, OUT = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(f"localhost:{PORT}", 2, RANK, device="cpu")
"""


def _run_ranks(body, out_dir, n=2, timeout=TIMEOUT):
    """Run ``PRELUDE + body`` as ranks 0..n-1 of one gloo group; returns
    each rank's output (stdout and stderr)."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", PRELUDE + body, str(r), str(port),
                               str(out_dir)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            p.kill()
    return outs


# ---- the sharded search across two ranks ------------------------------------------

# (dtype, metric): every dtype, both metrics, int8 IP only.
SEARCH_CASES = [("float32", "IP"), ("float32", "L2"), ("bfloat16", "IP"),
                ("bfloat16", "L2"), ("int8", "IP")]


def _search_inputs(dtype):
    """JAX's two-process test's inputs (seed 3: a 21 x 16 query block over
    300 rows, then 21 x 16 over 16,384 rows). Over int8 each reference row
    holds one ±127, so its scale is 1 and its codes are its values."""
    rng = np.random.RandomState(3)
    q = rng.randint(-3, 4, size=(21, 16)).astype(np.float32)
    r = rng.randint(-3, 4, size=(300, 16)).astype(np.float32)
    q2 = rng.randint(-3, 4, size=(21, 16)).astype(np.float32)
    r2 = rng.randint(-3, 4, size=(16384, 16)).astype(np.float32)
    if dtype == "int8":
        for rows in (r, r2):
            rows[np.arange(rows.shape[0]), rng.randint(0, 16, rows.shape[0])] = (
                rng.choice([-127.0, 127.0], rows.shape[0]))
    return q, r, q2, r2


SEARCH_WORKER = r"""
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_multihost import SEARCH_CASES, _search_inputs
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher

mesh = pod_mesh(["cpu"] * 4)
assert mesh.size == 8 and mesh.spans_processes and len(mesh.local) == 4, mesh
got = {}
for dtype, metric in SEARCH_CASES:
    tag = f"{dtype}_{metric}"
    q, r, q2, r2 = _search_inputs(dtype)
    os.environ[COLLECTION_ENV] = "stream"
    s = ShardedSimilaritySearcher(r, mesh, metric=metric, dtype=dtype)
    for k in (50, 700):
        got[f"{tag}_stream_{k}"] = s.global_topk(q, k)
    # Rows move between the ranks: 1,030 rows (256 a shard: rank 1 holds
    # shard 4) grow to 2,130 (384 a shard), then every third is kept.
    s = ShardedSimilaritySearcher(r2[:1030], mesh, metric=metric, dtype=dtype)
    s.append_rows(r2[1030:2130])
    assert s.shard_rows == 384, s.shard_rows
    got[f"{tag}_append"] = s.global_topk(q, 400)
    s.keep_rows(np.arange(0, s.n_refs, 3))
    got[f"{tag}_keep"] = s.global_topk(q, 120)
    got[f"{tag}_row_nn"] = (s.row_nn(q),)
    os.environ[COLLECTION_ENV] = "pooled"
    pooled = ShardedSimilaritySearcher(r2, mesh, metric=metric, dtype=dtype)
    assert pooled._collection_mode(24, pooled._plan(21, 700)[0]) == "pooled"
    got[f"{tag}_pooled"] = pooled.global_topk(q2, 700)
    assert pooled.last_stats["mode"] == "pooled", pooled.last_stats
    got[f"{tag}_staged"] = (np.asarray([pooled.staged_bytes()]),)
np.savez(os.path.join(OUT, f"search{RANK}.npz"),
         **{f"{key}_{i}": a for key, arrays in got.items() for i, a in enumerate(arrays)})
print("SEARCH RANK", RANK, "OK", flush=True)
"""

# The collectives and the pod's row-sharded table, in the same two ranks.
COLLECTIVES_WORKER = r"""
from vsc2022_torch.localization.localize import RowShardedTable
from vsc2022_torch.parallel import collectives
from vsc2022_torch.parallel.mesh import Mesh

mesh = pod_mesh(["cpu"] * (1 + RANK))  # rank 0: entry 0; rank 1: entries 1, 2
assert mesh.ranks == (0, 1, 1) and mesh.local == ((0,) if RANK == 0 else (1, 2))
out = {}
# Ragged along dim 1 (rank 0: 2 columns; rank 1: 1 + 3), and rank 1 with
# no part at all along dim 0.
parts = [torch.full((2, 1 + 2 * s), float(s)) for s in mesh.local]
out["gather1"] = collectives.all_gather(mesh, parts, 1)
rows = [] if RANK else [torch.arange(6, dtype=torch.int64).view(3, 2)]
out["gather0"] = collectives.all_gather(mesh, rows, 0, torch.empty((0, 2), dtype=torch.int64))
out["psum"] = collectives.psum(mesh, [torch.tensor([s, 10], dtype=torch.int32)
                                      for s in mesh.local], torch.zeros(2, dtype=torch.int32))
out["pmax"] = collectives.pmax(mesh, [torch.tensor([-float(s), float(s)]) for s in mesh.local],
                               torch.full((2,), float("-inf")))
out["scalar"] = collectives.pmax(mesh, [torch.tensor([1.5 + RANK], dtype=torch.float64)],
                                 torch.full((1,), float("-inf"), dtype=torch.float64))
try:
    collectives.psum(mesh, [torch.ones(2)], torch.zeros(2))
    raise SystemExit("psum summed floats")
except TypeError:
    pass
# exchange: rank 0 sends 2 rows to rank 1, rank 1 sends 3 to rank 0.
send = {1 - RANK: torch.arange(2 + RANK, dtype=torch.float32)[:, None] + 100 * RANK}
got = collectives.exchange(mesh, send, {1 - RANK: 3 - RANK}, torch.empty((0, 1)))
out["exchange"] = got[1 - RANK]
# A row-sharded table over the pod: 7 rows, 3 a shard; grown, compacted,
# and fetched for every entry, each rank its own entries' rows.
table = RowShardedTable.of(mesh, torch.arange(14, dtype=torch.float32).view(7, 2), torch.float32)
table = table.append(torch.arange(14, 20, dtype=torch.float32).view(3, 2))
table = table.take(np.array([0, 9, 2, 8, 5, 6, 1]))
wants = [np.array([[6, 0], [3, 3]]), np.array([1, 5]), None]
for s, rows in enumerate(table.fetch(wants)):
    if rows is not None:
        out[f"fetch{s}"] = rows
# Data-parallel batches split over one process's devices: a pod's ranks
# extract their own videos (the CLI's --num_processes).
from vsc2022_torch.inference.pipeline import DescriptorExtractor
from vsc2022_torch.parallel.mesh import first_axis_sharding
for make in (lambda: DescriptorExtractor(torch.nn.Identity(), None, batch_size=3, mesh=mesh),
             lambda: first_axis_sharding(mesh)):
    try:
        make()
        raise SystemExit("a pod mesh was taken for data-parallel batches")
    except ValueError:
        pass
np.savez(os.path.join(OUT, f"coll{RANK}.npz"), **{k: v.numpy() for k, v in out.items()})
print("COLLECTIVES RANK", RANK, "OK", flush=True)
"""


@pytest.fixture(scope="module")
def pod_ranks(tmp_path_factory):
    """One two-rank pod running the search and the collectives workers:
    its output directory."""
    out = tmp_path_factory.mktemp("pod_ranks")
    outs = _run_ranks(SEARCH_WORKER + COLLECTIVES_WORKER, out)
    for r, text in enumerate(outs):
        assert f"SEARCH RANK {r} OK" in text and f"COLLECTIVES RANK {r} OK" in text
    return out


@pytest.fixture(scope="module")
def pod_search(pod_ranks):
    return [dict(np.load(pod_ranks / f"search{r}.npz")) for r in range(2)]


def _jax_topk(searcher, q, k):
    return tuple(np.asarray(a) for a in searcher.global_topk(q, k))


def _equal(got, key, want):
    for i, w in enumerate(want):
        g = got[f"{key}_{i}"]
        np.testing.assert_array_equal(g, w, err_msg=key)
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)


@pytest.mark.parametrize("dtype,metric", SEARCH_CASES)
def test_pod_search_equals_jax_single_device(pod_search, monkeypatch, dtype, metric):
    # Both collections (the stream, and the pool forced at 16,384 rows as
    # JAX's test forces it) return the JAX single-device searcher's pairs,
    # scores and tie order, on both ranks; after append/keep (rows moved
    # between the ranks) the pod searches as JAX's searcher built on the
    # grown and the kept rows.
    from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher

    tag = f"{dtype}_{metric}"
    rank0, rank1 = pod_search
    assert {k for k in rank0 if k.startswith(tag)} == {k for k in rank1 if k.startswith(tag)}
    for key in rank0:
        if key.startswith(tag) and "staged" not in key:
            np.testing.assert_array_equal(rank0[key], rank1[key], err_msg=key)
    q, r, q2, r2 = _search_inputs(dtype)
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", "stream")
    single = JaxSearcher(r, metric=metric, dtype=dtype)
    for k in (50, 700):
        _equal(rank0, f"{tag}_stream_{k}", _jax_topk(single, q, k))
    grown = r2[:2130]
    kept = grown[np.arange(0, grown.shape[0], 3)]
    _equal(rank0, f"{tag}_append",
           _jax_topk(JaxSearcher(grown, metric=metric, dtype=dtype), q, 400))
    single = JaxSearcher(kept, metric=metric, dtype=dtype)
    _equal(rank0, f"{tag}_keep", _jax_topk(single, q, 120))
    _equal(rank0, f"{tag}_row_nn", (np.asarray(single.row_nn(q)),))
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", "pooled")
    _equal(rank0, f"{tag}_pooled",
           _jax_topk(JaxSearcher(r2, metric=metric, dtype=dtype), q2, 700))
    # Each rank stages its own four shards only: half of the pod's rows.
    assert rank0[f"{tag}_staged_0"] == rank1[f"{tag}_staged_0"] > 0


# ---- the inference CLI as a two-rank job ------------------------------------------------

W, H, FRAMES_PER_VIDEO = 32, 24, 3


def _executable(path, content):
    path.write_text(content)
    os.chmod(path, 0o755)


@pytest.fixture()
def stub_videos(tmp_path):
    """JAX's multi-host test's stubs: ffprobe reports 32 x 24, ffmpeg writes
    3 frames filled with (seed + j), seed the video file's first byte; four
    videos with distinct seeds."""
    tools = tmp_path / "tools"
    tools.mkdir()
    _executable(tools / "ffprobe", "#!/bin/bash\n"
                f'echo \'{{"streams": [{{"width": {W}, "height": {H}}}]}}\'\n')
    _executable(tools / "ffmpeg", "#!/usr/bin/env python3\n"
                "import sys\n"
                "path = sys.argv[sys.argv.index('-i') + 1]\n"
                "seed = open(path, 'rb').read(1)[0]\n"
                f"for j in range({FRAMES_PER_VIDEO}):\n"
                f"    sys.stdout.buffer.write(bytes([(seed + j) % 256]) * {W * H * 3})\n")
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(4):
        (videos / f"vid{i}.mp4").write_bytes(bytes([40 * i + 7]))
    return str(tools / "ffmpeg"), str(videos)


def _cli(ffmpeg, videos, out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "vsc2022_torch.inference.cli", "--baseline", "sscd",
         "--device", "cpu", "--transforms", "RESIZE_224_SQUARE", "--batch_size", "8",
         "--dataset_path", videos, "--ffmpeg_path", ffmpeg, "--output_file", out, *extra],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_two_rank_job_matches_one_process(stub_videos, tmp_path):
    # Each rank takes the round-robin shard (rank 0: vid0 and vid2) and
    # writes its own file; the merged shards equal one process's run bit
    # for bit.
    from vsc2022_torch.inference.pipeline import merge_feature_files
    from vsc2022_torch.storage import load_features

    ffmpeg, videos = stub_videos
    port = _free_port()
    shards = [str(tmp_path / f"shard{i}.npz") for i in range(2)]
    single = str(tmp_path / "single.npz")
    procs = [_cli(ffmpeg, videos, shards[i], "--coordinator", f"localhost:{port}",
                  "--num_processes", "2", "--process_id", str(i)) for i in range(2)]
    procs.append(_cli(ffmpeg, videos, single))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and "Inference succeeded" in out, out[-3000:]
    finally:
        _stop(*procs)
    merged = str(tmp_path / "merged.npz")
    assert merge_feature_files(shards, merged) == 4
    got = {vf.video_id: vf for vf in load_features(merged)}
    want = {vf.video_id: vf for vf in load_features(single)}
    assert set(got) == set(want) == {f"vid{i}" for i in range(4)}
    assert {vf.video_id for vf in load_features(shards[0])} == {"vid0", "vid2"}
    for vid in want:
        np.testing.assert_array_equal(got[vid].feature, want[vid].feature)
        np.testing.assert_array_equal(got[vid].timestamps, want[vid].timestamps)


# ---- the serving pod ------------------------------------------------------------------


def _serve_proc(argv, stderr=subprocess.DEVNULL):
    return subprocess.Popen([sys.executable, "-m", "vsc2022_torch.retrieval.serve", *argv,
                             "--device", "cpu"], cwd=REPO, env=_env(),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr)


def _wait_line(proc, prefix):
    """Skip stdout lines until one starts with ``prefix``."""
    for _ in range(50):
        line = proc.stdout.readline()
        if line.startswith(prefix):
            return line
        assert line, f"EOF waiting for {prefix!r}"
    raise AssertionError(f"never saw {prefix!r}")


def _pod(argv, stderr=subprocess.DEVNULL):
    """A leader and a follower serving ``argv`` as a two-rank pod on the
    CPU (gloo): (leader, follower), both staged."""
    coord, control = _free_port(), _free_port()
    flags = [*argv, "--sharded", "--coordinator", f"localhost:{coord}",
             "--num_processes", "2", "--control", f"localhost:{control}"]
    leader = _serve_proc([*flags, "--process_id", "0"])
    follower = _serve_proc([*flags, "--process_id", "1"], stderr=stderr)
    _wait_line(follower, b"follower\t1\t")
    _wait_line(leader, b"ready")
    return leader, follower


def _stop(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=TIMEOUT)


def _request(proc, line):
    proc.stdin.write((line + "\n").encode("utf-8"))
    proc.stdin.flush()
    return proc.stdout.readline().decode("utf-8").strip()


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def pod_corpus(tmp_path_factory):
    """JAX's serving-pod test's corpus (seed 11, D = 24): 10 references, 6
    noise videos, 3 queries (two with a planted copy), one video to add."""
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    root = tmp_path_factory.mktemp("pod_serve")
    rng = np.random.RandomState(11)
    d = 24
    refs = [VideoFeature(i, np.arange(n := int(rng.randint(20, 40)), dtype=np.float64),
                         _unit(rng.randn(n, d)).astype(np.float32)) for i in range(10)]
    noise = [VideoFeature(1000 + i, np.arange(25, dtype=np.float64),
                          _unit(rng.randn(25, d)).astype(np.float32)) for i in range(6)]
    queries = []
    for i in range(3):
        f = _unit(rng.randn(30, d)).astype(np.float32)
        if i < 2:
            f[10:18] = refs[i].feature[5:13]
        queries.append(VideoFeature(i, np.arange(30, dtype=np.float64), f))
    paths = {k: str(root / f"{k}.npz") for k in ("r", "noise", "q", "add")}
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["noise"], noise, Dataset.REFS)
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["add"], [VideoFeature(77, np.arange(20, dtype=np.float64), _unit(
        np.random.RandomState(41).randn(20, d)).astype(np.float32))], Dataset.REFS)
    paths["root"] = root
    return paths


def _lifecycle(proc, paths, tag):
    """The JAX test's request sequence: search with matches, add, remove, a
    failing remove, search, in-band searchb, save, quit. Returns the
    replies without their seconds, the output files and the in-band CSVs."""
    root, q = paths["root"], paths["q"]
    out = {k: str(root / f"{tag}_{k}") for k in ("1.csv", "1m.csv", "2.csv", "2m.csv",
                                                 "snap.npz")}
    replies = [_request(proc, f"{q}\t{out['1.csv']}\t{out['1m.csv']}"),
               _request(proc, f"add\t{paths['add']}"),
               _request(proc, "remove\tR000002"),
               _request(proc, "remove\tR999999"),
               _request(proc, f"{q}\t{out['2.csv']}\t{out['2m.csv']}")]
    q_bytes = open(q, "rb").read()
    proc.stdin.write(f"searchb\t{len(q_bytes)}\n".encode("utf-8") + q_bytes)
    proc.stdin.flush()
    head = proc.stdout.readline().decode("utf-8").strip().split("\t")
    assert head[0] == "okb", head
    inband = (proc.stdout.read(int(head[2])), proc.stdout.read(int(head[4])))
    replies.append(_request(proc, f"save\t{out['snap.npz']}"))
    proc.stdin.write(b"quit\n")
    proc.stdin.flush()
    assert [r.split("\t")[0] for r in replies] == ["ok", "ok", "ok", "error", "ok", "ok"]
    assert replies[1].split("\t")[:3] == ["ok", "added", "1"]
    assert replies[2].split("\t")[:3] == ["ok", "removed", "1"]
    assert replies[5].split("\t")[:3] == ["ok", "saved", "10"]
    stripped = [r if r.startswith("error") else "\t".join(r.split("\t")[:-1])
                for r in replies]
    return [s.replace(str(root / f"{tag}_"), "@") for s in stripped], out, inband


def test_serving_pod_matches_one_process(pod_corpus):
    # Rank 0 speaks the client protocol and relays every request to rank 1
    # over --control; both run the same collectives. The whole lifecycle
    # equals one unsharded one-process server on the JAX server's default
    # flags (bf16), byte for byte: replies, CSVs, in-band bytes, snapshot.
    argv = ["--ref_features", pod_corpus["r"], "--score_norm_features",
            pod_corpus["noise"], "--matches"]
    single = _serve_proc(argv)
    leader, follower = _pod(argv)
    try:
        assert single.stdout.readline().startswith(b"ready\t10\t")
        want = _lifecycle(single, pod_corpus, "single")
        got = _lifecycle(leader, pod_corpus, "pod")
        assert single.wait(timeout=TIMEOUT) == 0
        assert leader.wait(timeout=TIMEOUT) == 0
        # quit on the leader releases the follower through the relay.
        assert follower.wait(timeout=TIMEOUT) == 0
    finally:
        _stop(single, leader, follower)
    assert got[0] == want[0]
    for name in ("1.csv", "1m.csv", "2.csv", "2m.csv", "snap.npz"):
        with open(want[1][name], "rb") as a, open(got[1][name], "rb") as b:
            assert a.read() == b.read(), name
    assert got[2] == want[2] and got[2][0].count(b"\n") > 1
    # The JAX server, in process, over the same requests: the same replies
    # (counts and errors) and the same snapshot.
    from vsc2022_tpu.metrics import CandidatePair
    from vsc2022_tpu.retrieval import serve as jax_serve
    from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation

    jargs = jax_serve.parser.parse_args(argv)
    index, refs, _ = jax_serve.build_index(jargs)
    loc = jax_serve.build_localizer(index, refs, jargs)
    root = pod_corpus["root"]
    lines = [f"{pod_corpus['q']}\t{root}/jax_1.csv\t{root}/jax_1m.csv",
             f"add\t{pod_corpus['add']}", "remove\tR000002", "remove\tR999999",
             f"{pod_corpus['q']}\t{root}/jax_2.csv\t{root}/jax_2m.csv",
             f"save\t{root}/jax_snap.npz"]
    replies = []
    for line in lines:
        try:
            replies.append(jax_serve.serve_request(index, MaxScoreAggregation(), loc, line,
                                                   jargs))
        except Exception as exc:
            replies.append(f"error\t{exc}")
    kinds = [r.split("\t")[0] for r in replies]
    assert kinds == [r.split("\t")[0] for r in want[0][:4]] + ["ok", "ok"]
    assert [r.split("\t")[1:3] for r in replies[1:3]] == [g.split("\t")[1:3]
                                                          for g in got[0][1:3]]
    assert len(CandidatePair.read_csv(f"{root}/jax_2.csv")) == int(got[0][4].split("\t")[2])
    with np.load(f"{root}/jax_snap.npz") as a, np.load(got[1]["snap.npz"]) as b:
        for key in ("video_ids", "features", "timestamps"):
            np.testing.assert_array_equal(b[key], a[key])


def test_serving_pod_follower_death_fails_fast(tmp_path):
    # When a follower dies, device requests turn into error responses (a
    # collective on a broken pod would hang the leader), and quit still
    # ends the leader.
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.RandomState(5)
    d = 16
    refs = [VideoFeature(i, np.arange(20, dtype=np.float64),
                         _unit(rng.randn(20, d)).astype(np.float32)) for i in range(6)]
    q = rng.randn(15, d).astype(np.float32)
    r_npz, q_npz = str(tmp_path / "r.npz"), str(tmp_path / "q.npz")
    store_features(r_npz, refs, Dataset.REFS)
    store_features(q_npz, [VideoFeature(0, np.arange(15, dtype=np.float64), _unit(q))],
                   Dataset.QUERIES)
    leader, follower = _pod(["--ref_features", r_npz])
    out = str(tmp_path / "c.csv")
    try:
        assert _request(leader, f"{q_npz}\t{out}").startswith("ok\t")
        follower.send_signal(signal.SIGKILL)
        follower.wait(timeout=TIMEOUT)
        time.sleep(0.5)  # the FIN reaches the leader's control connection
        first = _request(leader, f"{q_npz}\t{out}")
        assert first.startswith("error\t") and "rank" in first and "restart" in first, first
        second = _request(leader, f"{q_npz}\t{out}")
        assert second.startswith("error\t") and "degraded" in second, second
        leader.stdin.write(b"quit\n")
        leader.stdin.flush()
        leader.wait(timeout=TIMEOUT)  # it ends; no hang in a half-pod collective
    finally:
        _stop(leader, follower)


def test_serving_pod_dns_two_stage_matches_one_process(tmp_path):
    # The DnS track over a two-rank pod: the two-file requests relay to the
    # follower, both reference tables (coarse and fine) are row-sharded
    # over the pod, and search, add and save equal one unsharded
    # one-process DnS server byte for byte.
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.models.dns import NUM_REGIONS
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.RandomState(23)
    rdim = 16

    def unit_fine(n):
        x = rng.normal(size=(n, NUM_REGIONS, rdim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def coarse_from(fine):
        return _unit(fine.mean(axis=1))

    r_fine = [unit_fine(int(rng.randint(24, 40))) for _ in range(4)]
    q_fine = [unit_fine(28) for _ in range(3)]
    q_fine[0][8:20] = r_fine[0][5:17]
    q_fine[1][2:12] = r_fine[2][10:20]

    def feats(prefix, fines):
        flat = [VideoFeature(f"{prefix}{i:06d}", np.arange(f.shape[0], dtype=np.float64),
                             f.reshape(f.shape[0], -1)) for i, f in enumerate(fines)]
        return flat, [VideoFeature(v.video_id, v.timestamps, coarse_from(f))
                      for v, f in zip(flat, fines)]

    rf, rc = feats("R", r_fine)
    qf, qc = feats("Q", q_fine)
    paths = {}
    for name, vids, ds in (("rc", rc, Dataset.REFS), ("rf", rf, Dataset.REFS),
                           ("qc", qc, Dataset.QUERIES), ("qf", qf, Dataset.QUERIES)):
        paths[name] = str(tmp_path / f"{name}.npz")
        store_features(paths[name], vids, ds)
    nr_fine = unit_fine(14)
    nrf = VideoFeature("R000099", np.arange(14, dtype=np.float64), nr_fine.reshape(14, -1))
    nrc = VideoFeature("R000099", nrf.timestamps, coarse_from(nr_fine))
    add_c, add_f = str(tmp_path / "add_c.npz"), str(tmp_path / "add_f.npz")
    store_features(add_c, [nrc], Dataset.REFS)
    store_features(add_f, [nrf], Dataset.REFS)

    def drive(proc, tag):
        out = [str(tmp_path / f"{tag}_{k}") for k in ("c1.csv", "m1.csv", "c2.csv",
                                                      "m2.csv", "snap_c.npz", "snap_f.npz")]
        assert _request(proc, f"{paths['qc']}\t{paths['qf']}\t{out[0]}\t{out[1]}"
                        ).startswith("ok\t")
        assert _request(proc, f"add\t{add_c}\t{add_f}").split("\t")[:3] == ["ok", "added", "1"]
        assert _request(proc, f"{paths['qc']}\t{paths['qf']}\t{out[2]}\t{out[3]}"
                        ).startswith("ok\t")
        assert _request(proc, f"save\t{out[4]}\t{out[5]}").split("\t")[:3] == [
            "ok", "saved", "5"]
        proc.stdin.write(b"quit\n")
        proc.stdin.flush()
        return out

    argv = ["--ref_features", paths["rc"], "--ref_fine_features", paths["rf"]]
    single = _serve_proc(argv)
    leader, follower = _pod(argv)
    try:
        assert single.stdout.readline().startswith(b"ready")
        want, got = drive(single, "single"), drive(leader, "pod")
        assert single.wait(timeout=TIMEOUT) == leader.wait(timeout=TIMEOUT) == 0
        assert follower.wait(timeout=TIMEOUT) == 0
    finally:
        _stop(single, leader, follower)
    for w, g in zip(want, got):
        with open(w, "rb") as a, open(g, "rb") as b:
            assert a.read() == b.read(), (w, g)
    assert open(got[1], "rb").read().count(b"\n") > 1  # planted copies found


# ---- the collectives, the backend rule and the flags ---------------------------------




def test_collectives_across_two_ranks(pod_ranks):
    got = [dict(np.load(pod_ranks / f"coll{r}.npz")) for r in range(2)]
    for key in ("gather1", "gather0", "psum", "pmax", "scalar"):
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    g = got[0]
    np.testing.assert_array_equal(g["gather1"], [[0, 1, 1, 1, 2, 2, 2, 2, 2]] * 2)
    np.testing.assert_array_equal(g["gather0"], np.arange(6).reshape(3, 2))
    np.testing.assert_array_equal(g["psum"], [3, 30])
    assert g["psum"].dtype == np.int32
    np.testing.assert_array_equal(g["pmax"], [0.0, 2.0])
    np.testing.assert_array_equal(g["scalar"], [2.5])
    np.testing.assert_array_equal(got[0]["exchange"][:, 0], [100, 101, 102])
    np.testing.assert_array_equal(got[1]["exchange"][:, 0], [0, 1])
    # The table's rows after append and take: [0, 9, 2, 8, 5, 6, 1] of
    # arange(20).view(10, 2).
    rows = np.arange(20).reshape(10, 2)[[0, 9, 2, 8, 5, 6, 1]]
    np.testing.assert_array_equal(got[0]["fetch0"], rows[[[6, 0], [3, 3]]])
    np.testing.assert_array_equal(got[1]["fetch1"], rows[[1, 5]])
    assert "fetch2" not in got[1] and "fetch1" not in got[0]


def test_backend_rule_is_explicit(monkeypatch):
    # NCCL on a card, gloo on the CPU; never chosen after an NCCL failure:
    # the choice is made before the group is joined, from the rank's device.
    import torch
    import torch.distributed as dist

    from vsc2022_torch.parallel import mesh as mesh_mod

    joined = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: joined.append(
        (backend, kw["init_method"], kw["world_size"], kw["rank"])))
    assert mesh_mod.initialize_distributed("h:1", 1, 0) is None and not joined
    mesh_mod.initialize_distributed("h:1", 2, 1, device="cpu")
    mesh_mod.initialize_distributed("h:1", 2, 1, backend="gloo", device="cpu")
    # On a machine with 3 cards: the cuda default takes card process_id % 3.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: joined.append(str(dev)))
    assert mesh_mod.rank_device("cuda", 4) == torch.device("cuda", 1)
    assert mesh_mod.rank_device("cuda:2", 4) == torch.device("cuda", 2)
    assert mesh_mod.initialize_distributed("h:1", 4, 2) == torch.device("cuda", 2)
    mesh_mod.initialize_distributed("h:1", 4, 3, backend="gloo")  # ranks sharing a card
    assert joined == [("gloo", "tcp://h:1", 2, 1), ("gloo", "tcp://h:1", 2, 1), "cuda:2",
                      ("nccl", "tcp://h:1", 4, 2), "cuda:0", ("gloo", "tcp://h:1", 4, 3)]
    for kw, message in (({"backend": "nccl", "device": "cpu"}, "needs a card"),
                        ({"backend": "mpi"}, "nccl")):
        with pytest.raises(ValueError, match=message):
            mesh_mod.initialize_distributed("h:1", 2, 0, **kw)


@pytest.mark.parametrize("flags,message", [
    (["--num_processes", "2"], "requires --coordinator"),
    (["--num_processes", "2", "--coordinator", "h:1"], "requires --control"),
    (["--num_processes", "2", "--coordinator", "h:1", "--control", "h:2"], "--sharded"),
    (["--num_processes", "2", "--coordinator", "h:1", "--control", "h:2", "--sharded",
      "--process_id", "2"], "out of range"),
    (["--process_id", "1"], "need --num_processes > 1"),
    (["--control", "h:2"], "need --num_processes > 1"),
])
def test_serve_rejects_the_pod_flags_jax_rejects(tmp_path, flags, message):
    from vsc2022_torch.retrieval import serve as torch_serve
    from vsc2022_tpu.retrieval import serve as jax_serve

    base = ["--ref_features", str(tmp_path / "absent.npz")]
    with pytest.raises(Exception, match=message):
        jax_serve.main(jax_serve.parser.parse_args(base + flags))
    with pytest.raises(ValueError, match=message):
        torch_serve.main(torch_serve.parser.parse_args(base + flags + ["--device", "cpu"]))
