"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no module of it (nor chip_smoke.py) imports them, and asking
for CUDA where there is none raises instead of falling back."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "vsc2022_torch"
FORBIDDEN = ("jax", "jaxlib", "vsc2022_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import vsc2022_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "vsc2022_torch.__path__, 'vsc2022_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'n': len(names), 'bad': sorted(m for m in "
        "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vsc2022_tpu'))}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["n"] >= 15
    assert report["bad"] == []


@pytest.mark.parametrize("module", [
    "vsc2022_torch.retrieval.serve", "vsc2022_torch.retrieval.client",
    "vsc2022_torch.retrieval.sn_search", "vsc2022_torch.inference.cli",
    "vsc2022_torch.inference.pipeline", "vsc2022_torch.models",
    "vsc2022_torch.convert", "vsc2022_torch.parallel",
    "vsc2022_torch.parallel.sharded_search", "vsc2022_torch.train",
    "vsc2022_torch.train.cli", "vsc2022_torch.train.augment",
])
def test_serving_modules_leave_jax_out(module):
    code = (
        f"import json, sys, {module}\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'jaxlib', 'vsc2022_tpu'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_without_gpu_raises(no_gpu):
    from vsc2022_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_points_default_to_cuda_and_raise(no_gpu, tmp_path):
    from vsc2022_torch.baseline import sscd_baseline
    from vsc2022_torch.ops.similarity import SimilaritySearcher
    from vsc2022_torch.retrieval.index import VideoIndex

    with pytest.raises(RuntimeError, match="CUDA"):
        SimilaritySearcher(np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoIndex(8)
    args = sscd_baseline.parser.parse_args([
        "--query_features", "q.npz", "--ref_features", "r.npz",
        "--output_path", str(tmp_path / "out"),
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        sscd_baseline.main(args)


def test_tensor_core_kernels_are_the_bf16_launch_keys():
    """Every bf16 launch key but the chamfer's (chamfer_bf16.cu, its own
    wgmma product) is a kernel of the tensor-core product
    (wgmma_gemm.cuh), and each of those has a wrapper
    (tools/bench_reduce.py reads the set)."""
    from vsc2022_torch.ops import kernels

    bf16_keys = {k[: -len(kernels.BF16)] for k in kernels.launches
                 if k.endswith(kernels.BF16) and k != kernels.CHAMFER_BF16}
    assert kernels.CHAMFER_BF16 in kernels.launches
    assert set(kernels.TENSOR_CORE_KERNELS) == bf16_keys
    assert all(callable(getattr(kernels, name)) for name in kernels.TENSOR_CORE_KERNELS)


def test_int8_launch_keys_are_the_tensor_core_kernels():
    """Every int8 kernel runs on the tensor-core product (wgmma_gemm.cuh's
    int8 corpus policy): one int8 launch key per TENSOR_CORE_KERNELS name,
    and no other product of ops/csrc holds an int8 path."""
    from vsc2022_torch.ops import kernels

    int8_keys = {k[: -len(kernels.INT8)] for k in kernels.launches
                 if k.endswith(kernels.INT8)}
    assert int8_keys == set(kernels.TENSOR_CORE_KERNELS)
    assert kernels.INT8_KERNELS == tuple(n + kernels.INT8 for n in kernels.TENSOR_CORE_KERNELS)
    csrc = pathlib.Path(kernels.__file__).resolve().parent / "csrc"
    for name in ("reduce_gemm.cuh", "tile_gemm.cuh"):
        assert "int8_t" not in (csrc / name).read_text()
    assert "struct I8Corpus" in (csrc / "wgmma_gemm.cuh").read_text()


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    from vsc2022_torch.ops import kernels

    kernels.reset_launches()
    q = torch.ones((3, 8))
    r = torch.ones((128, 8))
    kernels.row_max(q, r, 100)
    kernels.count_above(q, r, 0.0, 100)
    kernels.pool_writer(q, r, 100)
    kernels.fused_topk(q, torch.ones((100, 8)), 90, 4)
    kernels.chamfer_fine_sims(torch.ones((2, 3, 9, 8)), torch.ones((2, 5, 9, 8)))
    # bf16 operands take the plain versions on the CPU too.
    kernels.row_max(q.bfloat16(), r.bfloat16(), 100)
    kernels.pool_writer(q.bfloat16(), r.bfloat16(), 100)
    kernels.scores(q.bfloat16(), r.bfloat16(), 100)
    kernels.scores_above(q.bfloat16(), r.bfloat16(), 100, torch.zeros(3), capacity=1)
    # int8 codes (f32 queries, per-row scales) too.
    codes, scale = torch.ones((128, 16), dtype=torch.int8), torch.ones(128)
    kernels.row_max(q, codes, 100, scale=scale)
    kernels.count_above(q, codes, 0.0, 100, scale=scale)
    kernels.pool_writer(q, codes, 100, scale=scale)
    kernels.fused_topk(q, codes, 90, 4, scale=scale)
    kernels.scores(q, codes, 100, scale=scale)
    kernels.scores_above(q, codes, 100, torch.zeros(3), capacity=1, scale=scale)
    # L2 (the squared norms of the corpus rows and of the queries) in f32
    # and bf16 too.
    l2 = {"ref_sq": torch.ones(128), "q_sq": torch.ones(3)}
    for x, y in ((q, r), (q.bfloat16(), r.bfloat16())):
        kernels.row_max(x, y, 100, **l2)
        kernels.count_above(x, y, 0.0, 100, **l2)
        kernels.pool_writer(x, y, 100, **l2)
        kernels.fused_topk(x, y, 90, 4, **l2)
    kernels.scores_above(q.bfloat16(), r.bfloat16(), 100, torch.zeros(3), capacity=1, **l2)
    # The block subsets (the IVF tier's scans) in f32, bf16 and int8 too.
    blocks = {"blocks": torch.tensor([0], dtype=torch.int32), "col_block": 128}
    for x, y, kw in ((q, r, {}), (q.bfloat16(), r.bfloat16(), {}),
                     (q, codes, {"scale": scale})):
        kernels.count_above(x, y, 0.0, 100, **kw, **blocks)
        kernels.fused_topk(x, y, 90, 4, **kw, **blocks)
    # Plain versions never count as kernel launches.
    assert kernels.launches == {
        "row_max": 0, "count_above": 0, "pool_writer": 0, "fused_topk": 0,
        "chamfer": 0, "row_max.bf16": 0, "count_above.bf16": 0,
        "pool_writer.bf16": 0, "fused_topk.bf16": 0, "scores.bf16": 0,
        "scores_above.bf16": 0,
        "chamfer.bf16": 0, "row_max.int8": 0, "count_above.int8": 0,
        "pool_writer.int8": 0, "fused_topk.int8": 0, "scores.int8": 0,
        "scores_above.int8": 0, "row_max.l2": 0, "count_above.l2": 0,
        "pool_writer.l2": 0, "fused_topk.l2": 0, "row_max.bf16.l2": 0,
        "count_above.bf16.l2": 0, "pool_writer.bf16.l2": 0,
        "fused_topk.bf16.l2": 0, "scores_above.bf16.l2": 0,
        "count_above.blocks": 0, "count_above.bf16.blocks": 0,
        "count_above.int8.blocks": 0, "fused_topk.blocks": 0,
        "fused_topk.bf16.blocks": 0, "fused_topk.int8.blocks": 0,
    }
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.pool_writer(q, torch.ones((100, 8)), 100)
    with pytest.raises(ValueError, match="kappa"):
        kernels.fused_topk(q, r, 100, 0)
    with pytest.raises(TypeError):
        kernels.row_max(q.double(), r.double(), 100)
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.count_above(q.bfloat16(), r, 0.0, 100)
    fine = torch.ones((1, 4, 9, 8))
    # bf16 region features (precision "default") take the plain version on
    # the widened values; mixed dtypes raise.
    assert torch.equal(kernels.chamfer_fine_sims(fine.bfloat16(), fine.bfloat16()),
                       kernels.chamfer_fine_sims(fine, fine))
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.chamfer_fine_sims(fine.bfloat16(), fine)
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(fine, torch.ones((2, 4, 9, 8)))


def test_dns_entry_points_default_to_cuda_and_raise(no_gpu, tmp_path):
    from vsc2022_torch.baseline import dns_baseline, dns_index
    from vsc2022_torch.models.dns import DnSStudent

    with pytest.raises(RuntimeError, match="CUDA"):
        DnSStudent("cg")
    args = dns_index.parser.parse_args([
        "--query_features", "q.npz", "--ref_features", "r.npz",
        "--output_path", str(tmp_path / "idx"), "--student", "cg",
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        dns_index.main(args)
    args = dns_baseline.parser.parse_args([
        "--query_coarse_features", "qc.npz", "--ref_coarse_features", "rc.npz",
        "--query_fine_features", "qf.npz", "--ref_fine_features", "rf.npz",
        "--output_path", str(tmp_path / "out"),
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        dns_baseline.main(args)


def test_extraction_entry_points_default_to_cuda_and_raise(no_gpu, tmp_path):
    from vsc2022_torch.inference import cli
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.retrieval import serve

    model = torch.nn.Linear(3, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DescriptorExtractor(model, InferenceTransforms.RESIZE_224_SQUARE)
    args = cli.parser.parse_args(["--dataset_path", str(tmp_path),
                                  "--output_file", str(tmp_path / "o.npz")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    args = serve.parser.parse_args(["--ref_features", "r.npz", "--baseline", "sscd",
                                    "--checkpoint_path", "w.npz"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(args)


def test_serve_entry_point_defaults_to_cuda_and_raises(no_gpu):
    from vsc2022_torch.retrieval import serve
    from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher

    args = serve.parser.parse_args(["--ref_features", "r.npz", "--f32"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScoreNormalizedSearcher(np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32))


@pytest.mark.parametrize("entry", ["sscd_baseline", "descriptor_eval"])
def test_unported_storage_modes_raise(entry, tmp_path):
    # bf16 and int8 (SQ8) storage are both ported: --int8 runs (on the CPU
    # here) and its search corpus is int8; --sharded is ported too, and
    # descriptor_eval writes the same candidates with it.
    from vsc2022_torch import descriptor_eval
    from vsc2022_torch.baseline import sscd_baseline
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.ops import similarity
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.RandomState(0)

    def vids(n):
        return [VideoFeature(video_id=i, timestamps=np.arange(20, dtype=np.float64),
                             feature=rng.randint(-3, 4, (20, 8)).astype(np.float32))
                for i in range(n)]

    paths = {k: str(tmp_path / f"{k}.npz") for k in ("q", "r")}
    store_features(paths["q"], vids(2), Dataset.QUERIES)
    store_features(paths["r"], vids(5), Dataset.REFS)
    module = sscd_baseline if entry == "sscd_baseline" else descriptor_eval
    argv = ["--query_features", paths["q"], "--ref_features", paths["r"],
            "--device", "cpu", "--int8"]
    if entry == "sscd_baseline":
        argv += ["--output_path", str(tmp_path / "out")]
    else:
        argv += ["--candidates_output", str(tmp_path / "c.csv")]
    staged = []
    search = similarity.SimilaritySearcher.global_topk

    def spy(self, *args, **kwargs):
        staged.append((self.dtype, self._refs.dtype))
        return search(self, *args, **kwargs)

    similarity.SimilaritySearcher.global_topk = spy
    try:
        module.main(module.parser.parse_args(argv))
    finally:
        similarity.SimilaritySearcher.global_topk = search
    assert staged == [("int8", torch.int8)]
    out = tmp_path / ("out/candidates.csv" if entry == "sscd_baseline" else "c.csv")
    assert out.read_text().count("\n") > 1
    if entry == "descriptor_eval":
        sharded = tmp_path / "c_sharded.csv"
        module.main(module.parser.parse_args(
            argv[:-1] + [str(sharded), "--sharded"]))
        assert sharded.read_bytes() == out.read_bytes()


def test_bench_scores_above_needs_a_card():
    # tools/bench_scores_above.py stops with its own message when no card
    # is visible, before it imports the kernels.
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "bench_scores_above.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode == 2 and "no CUDA device" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("flags,rc,message", [
    (["--int8", "--only", "scores"], 2, "no CUDA device"),
    (["--int8"], 2, "no CUDA device"),
    (["--only", "scores"], 2, "--only scores times scores.int8: add --int8"),
    (["--bf16", "--int8"], 2, "not allowed with argument"),
])
def test_bench_reduce_flags(flags, rc, message):
    # tools/bench_reduce.py takes --int8 (and --only scores with it) and,
    # with no card (none is visible to the child), stops with its own
    # message; flags that do not go together are argparse's errors.
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "bench_reduce.py"), *flags],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode == rc, out.stderr
    assert message in out.stderr
    assert out.stdout == ""
    if message == "no CUDA device":
        assert "usage:" not in out.stderr
