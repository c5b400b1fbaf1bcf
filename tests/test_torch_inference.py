"""The port's extraction path against the JAX package's on the CPU:
``jax.image.resize``'s weights and ``preprocess`` in every mode, the
video dataset's glob / sort / shard, the ffmpeg pipe reader (stub
executables), ``DescriptorExtractor`` (padding, fp16 storage, bf16,
against JAX's extractor on shared weights), ``merge_feature_files``, the
CLI's parser against JAX's, and the CLI end to end on stub videos
(against the JAX CLI on the same npz checkpoint; ``--resume``,
``--processes``, ``--fold_bn`` and ``--store_fp16``).

Tolerances: resize weights within 2.4e-7 of JAX's (one or two f32 ulps of
the kernel sums). ``preprocess`` within 1e-4 of JAX's: XLA-CPU's resize
product lies up to 5.1e-5 from a float64 evaluation of the same weights
(on normalized values up to 2.7), the port's within 2e-6 of it, which is
held too. Descriptors within 1e-4 of JAX's (the preprocess gap carried
through the model); a padded batch within rtol 1e-5 / atol 1e-6 of an
unpadded one (the JAX package's own bound); bf16 within 2e-2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import (
    _fill_keys_cubic_kernel,
    _fill_triangle_kernel,
    compute_weight_mat,
)

from torch_video_stub import write_tools, write_video
from vsc2022_torch import convert
from vsc2022_torch.inference import cli as torch_cli
from vsc2022_torch.inference import transforms as T
from vsc2022_torch.inference.pipeline import (
    DescriptorExtractor,
    VideoDataset,
    merge_feature_files,
)
from vsc2022_torch.inference.video_reader import ArrayVideoReader, FFMpegVideoReader
from vsc2022_torch.models.sscd import SSCDModel
from vsc2022_torch.parallel import Mesh
from vsc2022_torch.storage import load_features, store_features
from vsc2022_torch.types import VideoFeature
from vsc2022_tpu.inference import cli as jax_cli
from vsc2022_tpu.inference import pipeline as jax_pipeline
from vsc2022_tpu.inference import transforms as J
from vsc2022_tpu.models import SSCDModel as JaxSSCD
from vsc2022_tpu.utils.checkpoint import save_variables

SMALL = dict(stage_sizes=(1, 1, 1, 1), stage_features=(8, 16, 32, 64))


# ---- transforms ------------------------------------------------------------


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("n_in,n_out", [(360, 320), (640, 569), (14, 20), (14, 2),
                                        (14, 3), (100, 320), (7, 7), (1, 5)])
def test_resize_weights_match_jax(method, n_in, n_out):
    kernel = _fill_triangle_kernel if method == "linear" else _fill_keys_cubic_kernel
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel, True))
    got = T.resize_weights(n_in, n_out, method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def _preprocess_f64(frames, mode):
    """The port's weights applied in float64: the arithmetic's reference."""
    _, h, w, _ = frames.shape
    rh, rw = T.resized_dims(mode, h, w)
    x = torch.from_numpy(frames).double() / 255.0
    if rh != h:
        x = torch.einsum("bhwc,ho->bowc", x, T.resize_weights(h, rh, "linear").double())
    if rw != w:
        x = torch.einsum("bhwc,wo->bhoc", x, T.resize_weights(w, rw, "linear").double())
    if mode == T.InferenceTransforms.RESIZE_320_CENTER:
        top, left = max((rh - 320) // 2, 0), max((rw - 320) // 2, 0)
        x = x[:, top:top + 320, left:left + 320]
    mean = torch.tensor(T.IMAGENET_MEAN, dtype=torch.float64)
    std = torch.tensor(T.IMAGENET_STD, dtype=torch.float64)
    return ((x - mean) / std).numpy()


@pytest.mark.parametrize("mode", list(T.InferenceTransforms), ids=lambda m: m.name)
@pytest.mark.parametrize("h,w", [(360, 640), (640, 360), (100, 150), (224, 224),
                                 (37, 53)])
def test_preprocess_matches_jax(mode, h, w):
    # Landscape, portrait, smaller than the crop (upscaled), square, odd.
    frames = np.random.RandomState(h * 7 + w).randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    want = np.asarray(J.preprocess(jnp.asarray(frames), J.InferenceTransforms[mode.name]))
    got = T.preprocess(torch.from_numpy(frames), mode).numpy()
    assert got.shape == want.shape == (2, *T.output_dims(mode, h, w), 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _preprocess_f64(frames, mode), rtol=0, atol=2e-6)


def test_output_dims_match_jax():
    for mode in T.InferenceTransforms:
        for h, w in ((360, 640), (640, 360), (1, 1000), (333, 333)):
            jm = J.InferenceTransforms[mode.name]
            assert T.resized_dims(mode, h, w) == J.resized_dims(jm, h, w)
            assert T.output_dims(mode, h, w) == J.output_dims(jm, h, w)


# ---- dataset and reader ----------------------------------------------------


def _touch(directory, names):
    for name in names:
        (directory / name).write_bytes(b"x")


def test_dataset_glob_sort_shard_as_jax(tmp_path):
    _touch(tmp_path, ["b.mp4", "a.mp4", "c.mp4", "d.avi", "e.mkv"])
    for ext in (["mp4"], ["mp4", "avi"]):
        for rank in range(2):
            got = VideoDataset(str(tmp_path), None, ext, rank, 2)
            want = jax_pipeline.VideoDataset(str(tmp_path), None, ext, rank, 2)
            assert got.selected_videos == want.selected_videos
    assert [os.path.basename(v) for _, v in
            VideoDataset(str(tmp_path), None, ["mp4"], 0, 2).selected_videos] == [
        "a.mp4", "c.mp4"]
    with pytest.raises(ValueError, match="rank"):
        VideoDataset(str(tmp_path), None, ["mp4"], 2, 2)


def test_empty_dataset_raises(tmp_path):
    with pytest.raises(Exception, match="No videos"):
        VideoDataset(str(tmp_path), None)


def test_ffmpeg_reader_on_stub_tools(tmp_path):
    ffmpeg = write_tools(tmp_path / "tools")
    write_video(tmp_path / "v.mp4", [(4, j) for j in range(5)], w=16, h=8)
    frames = list(FFMpegVideoReader(str(tmp_path / "v.mp4"), 2.0, ffmpeg_path=ffmpeg).frames())
    assert [(s, e) for s, e, _ in frames] == [(j / 2, (j + 1) / 2) for j in range(5)]
    assert all(f.shape == (8, 16, 3) and f.dtype == np.uint8 for _, _, f in frames)
    assert frames[0][2].std() > 10  # textured, not one colour
    compat = FFMpegVideoReader(str(tmp_path / "v.mp4"), 2.0, ffmpeg_path=ffmpeg,
                               reference_compat_timestamps=True)
    assert [(s, e) for s, e, _ in compat.frames()] == [(float(j), j + 1.0) for j in range(5)]
    with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
        FFMpegVideoReader("x.mp4", 1.0, ffmpeg_path="/nonexistent/ffmpeg")


# ---- the extractor ---------------------------------------------------------


class ArrayDataset(VideoDataset):
    """In-memory videos through ArrayVideoReader (no decode)."""

    def __init__(self, videos):
        self._videos = videos
        self.selected_videos = list(enumerate(sorted(videos)))

    def iter_decoded(self):
        for _, name in self.selected_videos:
            spans = [(s, e) for s, e, _ in ArrayVideoReader(self._videos[name]).frames()]
            yield name, self._videos[name], np.asarray(spans)


class JaxArrayDataset(jax_pipeline.VideoDataset):
    def __init__(self, videos):
        self._inner = ArrayDataset(videos)
        self.selected_videos = self._inner.selected_videos

    def iter_decoded(self):
        return self._inner.iter_decoded()


def _videos(seed, n=3, h=40, w=60):
    rng = np.random.RandomState(seed)
    return {f"Q{i:06d}": rng.randint(0, 256, (rng.randint(3, 9), h, w, 3)).astype(np.uint8)
            for i in range(n)}


@pytest.fixture(scope="module")
def small_sscd():
    jax_model = JaxSSCD(dims=16, **SMALL)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3))))
    return jax_model, variables, convert.sscd_from_jax(variables)


def _extractor(state, **kw):
    model = convert.load_into(SSCDModel(dims=16, **SMALL), state)
    kw.setdefault("device", "cpu")
    return DescriptorExtractor(model, T.InferenceTransforms.RESIZE_224_SQUARE, **kw)


def test_extractor_matches_jax(small_sscd):
    jax_model, variables, state = small_sscd
    videos = _videos(0)
    want = {vf.video_id: vf for vf in jax_pipeline.DescriptorExtractor(
        jax_model.apply, variables, J.InferenceTransforms.RESIZE_224_SQUARE,
        batch_size=4).extract(JaxArrayDataset(videos))}
    got = list(_extractor(state, batch_size=4).extract(ArrayDataset(videos)))
    assert [vf.video_id for vf in got] == sorted(videos)
    for vf in got:
        assert vf.feature.dtype == np.float32
        assert vf.feature.shape == (videos[vf.video_id].shape[0], 16)
        np.testing.assert_array_equal(vf.timestamps, want[vf.video_id].timestamps)
        np.testing.assert_allclose(vf.feature, want[vf.video_id].feature, rtol=0, atol=1e-4)


def test_padding_does_not_change_results(small_sscd):
    videos = _videos(1, n=2)
    outs = {}
    for bs in (3, 64):
        ex = _extractor(small_sscd[2], batch_size=bs)
        outs[bs] = {vf.video_id: vf.feature for vf in ex.extract(ArrayDataset(videos))}
        frames = sum(v.shape[0] for v in videos.values())
        assert ex.last_stats["frames"] == frames and ex.last_stats["videos"] == 2
        assert ex.last_stats["batches"] == sum(-(-v.shape[0] // bs) for v in videos.values())
    for vid in outs[3]:
        np.testing.assert_allclose(outs[3][vid], outs[64][vid], rtol=1e-5, atol=1e-6)


def test_store_fp16_and_bf16(small_sscd):
    videos = _videos(2, n=2)
    f32 = {vf.video_id: vf.feature for vf in
           _extractor(small_sscd[2], batch_size=4).extract(ArrayDataset(videos))}
    fp16 = list(_extractor(small_sscd[2], batch_size=4).extract(ArrayDataset(videos),
                                                               store_fp16=True))
    assert all(vf.feature.dtype == np.float16 for vf in fp16)
    bf16 = list(_extractor(small_sscd[2], batch_size=4, compute_dtype="bfloat16").extract(
        ArrayDataset(videos)))
    for vf in bf16:
        assert vf.feature.dtype == np.float32
        np.testing.assert_allclose(vf.feature, f32[vf.video_id], rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="compute_dtype"):
        _extractor(small_sscd[2], compute_dtype="float16")
    # mesh= is ported (tests/test_torch_sharded.py); a batch that does not
    # split evenly over the mesh raises, as JAX asserts.
    with pytest.raises(ValueError, match="batch_size"):
        _extractor(small_sscd[2], batch_size=4, mesh=Mesh(["cpu"] * 3))


def test_decode_errors_reach_the_caller(small_sscd):
    class Broken(ArrayDataset):
        def iter_decoded(self):
            yield from super().iter_decoded()
            raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(_extractor(small_sscd[2], batch_size=4).extract(Broken(_videos(3, n=1))))


def test_merge_feature_files(tmp_path):
    rng = np.random.RandomState(3)
    shards = []
    for rank in range(3):
        path = str(tmp_path / f"{rank}.npz")
        store_features(path, [VideoFeature(f"Q{rank * 10 + i:06d}",
                                           np.arange(4, dtype=np.float64),
                                           rng.randn(4, 8).astype(np.float32))
                              for i in range(2)])
        shards.append(path)
    assert merge_feature_files(shards, str(tmp_path / "m.npz")) == 6
    assert [vf.video_id for vf in load_features(str(tmp_path / "m.npz"))] == [
        f"Q{r * 10 + i:06d}" for r in range(3) for i in range(2)]


# ---- the CLI ---------------------------------------------------------------


def _actions(parser, skip=()):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.required,
                     type(a).__name__)
            for a in parser._actions if a.dest not in skip}


def test_cli_parser_matches_jax():
    # The JAX CLI's flags, choices and defaults; --accelerator (and the
    # port's --device) set the device: cuda by default, tpu selects the card.
    skip = ("help", "accelerator", "device")
    assert _actions(torch_cli.parser, skip) == _actions(jax_cli.parser, skip)
    base = ["--dataset_path", "v", "--output_file", "o.npz"]
    assert torch_cli.parser.parse_args(base).device == "cuda"
    for flags, device in ((["--accelerator", "cpu"], "cpu"), (["--accelerator", "tpu"], "cuda"),
                          (["--accelerator", "cuda"], "cuda"), (["--device", "cpu"], "cpu")):
        assert torch_cli.parser.parse_args(base + flags).device == device
    jax_accel = next(a for a in jax_cli.parser._actions if a.dest == "accelerator")
    port_accel = next(a for a in torch_cli.parser._actions if "--accelerator" in a.option_strings)
    assert set(jax_accel.choices) < set(port_accel.choices) == {"cpu", "cuda", "tpu"}


def test_cli_rejects_what_jax_rejects_and_the_unported():
    base = ["--dataset_path", "v", "--output_file", "o.npz"]
    with pytest.raises(Exception, match="either --processes"):
        torch_cli.main(torch_cli.parser.parse_args(
            base + ["--processes", "2", "--distributed_size", "2", "--device", "cpu"]))
    with pytest.raises(Exception, match="CPU-decode fan-out"):
        torch_cli.main(torch_cli.parser.parse_args(base + ["--processes", "2"]))
    # The multi-host job's flags, as JAX checks them (the two-rank job
    # itself: tests/test_torch_multihost.py).
    for flags, message in ((["--num_processes", "2"], "requires --coordinator"),
                           (["--num_processes", "2", "--processes", "2"], "excludes"),
                           (["--num_processes", "2", "--coordinator", "h:1",
                             "--process_id", "2"], "out of range")):
        with pytest.raises(Exception, match=message):
            torch_cli.main(torch_cli.parser.parse_args(base + flags + ["--device", "cpu"]))
        with pytest.raises(Exception, match=message):
            jax_cli.main(jax_cli.parser.parse_args(base + flags + ["--accelerator", "cpu"]))
    with pytest.raises(ValueError, match="DINO has no BatchNorm"):
        torch_cli.build_model(torch_cli.parser.parse_args(
            base + ["--baseline", "dino", "--fold_bn"]))
    with pytest.raises(ValueError, match="--checkpoint_path"):
        torch_cli.build_model(torch_cli.parser.parse_args(
            base + ["--baseline", "dns", "--torchscript_path", "x.pt"]))


@pytest.fixture(scope="module")
def stub_rig(tmp_path_factory):
    """Stub tools, two video directories and a full-size SSCD npz
    checkpoint (the JAX package's tree, BatchNorm statistics perturbed)."""
    tmp = tmp_path_factory.mktemp("cli")
    ffmpeg = write_tools(tmp / "tools")
    videos = tmp / "videos"
    videos.mkdir()
    for i, n in enumerate((3, 5, 2)):
        write_video(videos / f"R{i:06d}.mp4", [(10 + i, j) for j in range(n)])
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(JaxSSCD().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32), variables["batch_stats"])
    ckpt = str(tmp / "sscd.npz")
    save_variables(ckpt, variables)
    return tmp, ffmpeg, videos, ckpt


def _cli_argv(rig, out, *extra, videos=None):
    tmp, ffmpeg, default_videos, ckpt = rig
    return ["--baseline", "sscd", "--checkpoint_path", ckpt, "--accelerator", "cpu",
            "--transforms", "RESIZE_224_SQUARE", "--batch_size", "4",
            "--dataset_path", str(videos or default_videos), "--ffmpeg_path", ffmpeg,
            "--output_file", str(out), *extra]


def _npz(path):
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


@pytest.fixture(scope="module")
def cli_out(stub_rig):
    out = stub_rig[0] / "port.npz"
    torch_cli.main(torch_cli.parser.parse_args(_cli_argv(stub_rig, out)))
    return _npz(out)


def test_cli_matches_jax_cli(stub_rig, cli_out):
    out = stub_rig[0] / "jax.npz"
    jax_cli.main(jax_cli.parser.parse_args(_cli_argv(stub_rig, out)))
    want = _npz(out)
    assert list(cli_out["video_ids"]) == list(want["video_ids"]) == (
        ["R000000"] * 3 + ["R000001"] * 5 + ["R000002"] * 2)
    np.testing.assert_array_equal(cli_out["timestamps"], want["timestamps"])
    assert cli_out["features"].dtype == want["features"].dtype == np.float32
    assert cli_out["features"].shape == (10, 512)
    np.testing.assert_allclose(cli_out["features"], want["features"], rtol=0, atol=1e-4)


def test_cli_fold_bn_and_fp16(stub_rig, cli_out):
    out = stub_rig[0] / "fold.npz"
    torch_cli.main(torch_cli.parser.parse_args(
        _cli_argv(stub_rig, out, "--fold_bn", "--store_fp16")))
    got = _npz(out)
    assert got["features"].dtype == np.float16
    np.testing.assert_allclose(got["features"].astype(np.float32), cli_out["features"],
                               rtol=1e-3, atol=1e-3)  # fp16 storage of a folded ≡ model
    out = stub_rig[0] / "fold32.npz"
    torch_cli.main(torch_cli.parser.parse_args(_cli_argv(stub_rig, out, "--fold_bn")))
    np.testing.assert_allclose(_npz(out)["features"], cli_out["features"], rtol=0, atol=1e-5)


def test_cli_resume_extracts_only_the_missing(stub_rig, cli_out, tmp_path):
    tmp, _, videos, _ = stub_rig
    part = tmp_path / "part"
    part.mkdir()
    for name in ("R000000.mp4", "R000001.mp4"):
        (part / name).write_text((videos / name).read_text())
    out = tmp_path / "resume.npz"
    torch_cli.main(torch_cli.parser.parse_args(_cli_argv(stub_rig, out, videos=part)))
    first = _npz(out)
    (part / "R000002.mp4").write_text((videos / "R000002.mp4").read_text())
    (part / "R000000.mp4").write_text(json.dumps({"w": 1, "h": 1, "frames": []}))
    torch_cli.main(torch_cli.parser.parse_args(
        _cli_argv(stub_rig, out, "--resume", videos=part)))
    got = _npz(out)
    # The done videos are kept as they were (R000000's file now decodes to
    # nothing: it was not read again); the new one matches a fresh run.
    np.testing.assert_array_equal(got["features"][:8], first["features"])
    assert list(got["video_ids"]) == list(cli_out["video_ids"])
    np.testing.assert_array_equal(got["features"], cli_out["features"])


def test_cli_processes_spawn_and_merge(stub_rig, cli_out, tmp_path):
    out = tmp_path / "spawned.npz"
    torch_cli.main(torch_cli.parser.parse_args(
        _cli_argv(stub_rig, out, "--processes", "2", "--scratch_path", str(tmp_path / "s"))))
    got = _npz(out)
    # Rank 0 takes videos 0 and 2, rank 1 video 1; the merge is rank order.
    order = [0, 1, 2, 8, 9, 3, 4, 5, 6, 7]
    assert list(got["video_ids"]) == [cli_out["video_ids"][i] for i in order]
    np.testing.assert_allclose(got["features"], cli_out["features"][order], rtol=0, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "s")) == ["0.npz", "1.npz"]


def test_cli_runs_as_a_module(stub_rig, cli_out, tmp_path):
    import subprocess
    import sys

    out = tmp_path / "module.npz"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    r = subprocess.run([sys.executable, "-m", "vsc2022_torch.inference.cli",
                        *_cli_argv(stub_rig, out, "--distributed_rank", "1",
                                   "--distributed_size", "2")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "stages:" in r.stderr and "Inference succeeded" in r.stderr
    got = _npz(out)
    assert list(got["video_ids"]) == ["R000001"] * 5
    np.testing.assert_allclose(got["features"], cli_out["features"][3:8], rtol=0, atol=1e-6)


def test_entry_point_defaults_to_cuda(monkeypatch, stub_rig, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _cli_argv(stub_rig, tmp_path / "o.npz")
    at = argv.index("--accelerator")
    args = torch_cli.parser.parse_args(argv[:at] + argv[at + 2:])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli.main(args)
