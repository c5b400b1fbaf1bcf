"""The port's last entry points against the JAX package's: the umbrella
CLI (``python -m vsc2022_torch``) and ``adapt_model``.

``adapt_model`` must write the JAX package's checkpoint (the same npz
arrays for the same TorchScript file), verify it the JAX package's way
and probe with its exit codes. The TorchScript files are saved here from
the torch stand-ins of ``tests/test_convert_numerics.py``, at full width.
"""

import argparse
import functools
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

from test_convert_numerics import (
    ScriptableFineStudent,
    TorchCoarseStudent,
    TorchDinoViT,
    TorchSSCD,
    randomize_bn_stats,
)
from vsc2022_torch import __main__ as torch_main
from vsc2022_torch.baseline import adapt_model as torch_adapt
from vsc2022_torch.models.vit import interpolate_pos_embed
from vsc2022_tpu import __main__ as jax_main
from vsc2022_tpu.baseline import adapt_model as jax_adapt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["sscd", "dino", "dns_cg", "dns_fg_att", "dns_fg_bin"]


# ---- the umbrella CLI ----------------------------------------------------------------


def test_commands_are_the_jax_commands():
    assert list(torch_main.COMMANDS) == list(jax_main.COMMANDS)
    for name, (module, _) in torch_main.COMMANDS.items():
        assert module == jax_main.COMMANDS[name][0].replace("vsc2022_tpu", "vsc2022_torch")


@pytest.mark.parametrize("command", list(torch_main.COMMANDS))
def test_each_command_module_has_parser_and_main(command):
    module = importlib.import_module(torch_main.COMMANDS[command][0])
    assert isinstance(module.parser, argparse.ArgumentParser)
    assert callable(module.main)


@pytest.mark.parametrize("argv,code", [(["--help"], 0), (["no-such-command"], 2)])
def test_help_and_unknown_command_exit_codes(argv, code):
    out = subprocess.run([sys.executable, "-m", "vsc2022_torch", *argv], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == code
    assert "commands:" in out.stdout
    assert "python -m vsc2022_torch.descriptor_eval" in out.stdout
    assert torch_main.main([]) == 2  # no command at all


# ---- adapt_model ------------------------------------------------------------------------


class ScriptableCoarseStudent(TorchCoarseStudent):
    """The cg student with the reference artifact's ``index_video``
    (fed [T, 1, 9·3840] or [T, 9, 3840])."""

    @torch.jit.export
    def index_video(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x.reshape(x.shape[0], 9, 3840))


class ResampledDinoViT(TorchDinoViT):
    """DINO ViT-S/16 whose position embedding is resampled to the patch
    grid of its input (JAX's cubic), as the 64x64 verify input needs."""

    def forward(self, x):
        b = x.shape[0]
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        pos = interpolate_pos_embed(self.pos_embed, tokens.shape[1])
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1) + pos
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        gem = tokens[:, 1:].clamp(min=1e-6).pow(4.0).mean(dim=1).pow(1.0 / 4.0)
        return torch.cat([tokens[:, 0], gem], dim=1)


def _torchscript(model: str, path: str) -> None:
    torch.manual_seed(MODELS.index(model))
    if model == "sscd":
        net = TorchSSCD().eval()
        randomize_bn_stats(net, np.random.RandomState(0))
        with torch.no_grad():
            torch.jit.trace(net, torch.zeros(1, 3, 64, 64)).save(path)
    elif model == "dino":
        with torch.no_grad():
            torch.jit.trace(ResampledDinoViT().eval(), torch.zeros(1, 3, 64, 64)).save(path)
    elif model == "dns_cg":
        torch.jit.script(ScriptableCoarseStudent().eval()).save(path)
    else:
        torch.jit.script(ScriptableFineStudent(model.split("_")[-1]).eval()).save(path)


@pytest.fixture(scope="module")
def torchscripts(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapt")
    paths = {}
    for model in MODELS:
        paths[model] = str(root / f"{model}.pt")
        _torchscript(model, paths[model])
    return paths


def _args(ts, out, model, **kw):
    return argparse.Namespace(input_torchscript=ts, output_checkpoint=out, model=model,
                              strip_prefix=kw.get("strip_prefix", ""),
                              verify=kw.get("verify", False), device="cpu")


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("model", MODELS)
def test_adapt_model_writes_the_jax_checkpoint(torchscripts, tmp_path, model):
    jax_out, torch_out = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jax_adapt.main(_args(torchscripts[model], jax_out, model))
    torch_adapt.main(_args(torchscripts[model], torch_out, model, verify=True))
    _assert_same_npz(_npz(torch_out), _npz(jax_out))
    with pytest.raises(Exception, match="already exists"):
        torch_adapt.main(_args(torchscripts[model], torch_out, model))


@pytest.mark.parametrize("model", MODELS)
def test_verify_raises_on_weights_changed_after_reading(torchscripts, tmp_path,
                                                        monkeypatch, model):
    from vsc2022_torch import convert

    real = convert.load_torchscript_state

    def changed(path, strip_prefix=""):
        state = real(path, strip_prefix)
        key = max(state, key=lambda k: state[k].size)  # the largest tensor
        noise = np.random.RandomState(0).randn(*state[key].shape).astype(np.float32)
        state[key] = state[key] + 0.5 * noise
        return state

    monkeypatch.setattr(convert, "load_torchscript_state", changed)
    out = str(tmp_path / "bad.npz")
    with pytest.raises(Exception, match="Conversion mismatch"):
        torch_adapt.main(_args(torchscripts[model], out, model, verify=True))
    assert not os.path.exists(out)


class Holder(tnn.Module):
    """An artifact that nests the student under a prefix no wrapper rule
    strips (the beside-it ``tag`` keeps 'inner.' from being uniform)."""

    def __init__(self):
        super().__init__()
        self.inner = ScriptableFineStudent("bin")
        self.tag = tnn.Linear(1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner(x)


def test_strip_prefix_matches_jax(tmp_path):
    torch.manual_seed(11)
    ts = str(tmp_path / "held.pt")
    torch.jit.script(Holder().eval()).save(ts)
    outs = {side: str(tmp_path / f"{side}.npz") for side in ("jax", "torch")}
    jax_adapt.main(_args(ts, outs["jax"], "dns_fg_bin", strip_prefix="inner."))
    torch_adapt.main(_args(ts, outs["torch"], "dns_fg_bin", strip_prefix="inner."))
    _assert_same_npz(_npz(outs["torch"]), _npz(outs["jax"]))
    assert "params/rotation" in _npz(outs["torch"])


@functools.lru_cache(maxsize=None)
def _jax_expected_shapes(model):
    """JAX's ``_expected_shapes``: the shapes of a fresh Flax init of the
    model, traced abstractly (``jax.eval_shape``) instead of run."""
    import jax
    import jax.numpy as jnp

    from vsc2022_tpu.models import SSCDModel

    if model.startswith("dns_"):
        return None
    shapes = jax.eval_shape(SSCDModel().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    assert model == "sscd"  # the only family these cases probe
    return jax_adapt._shape_tree(shapes)


def _sscd_state(case):
    torch.manual_seed(3)
    state = {k.replace("backbone.", "trunk.", 1): v.detach().numpy()
             for k, v in TorchSSCD().state_dict().items()}
    if case == "missing":
        del state["trunk.layer3.2.conv2.weight"]
    elif case == "shape":
        state["project.weight"] = state["project.weight"][:256]
        state["project.bias"] = state["project.bias"][:256]
    return state


@pytest.mark.parametrize("model,case,code", [
    ("sscd", "ok", 0), ("sscd", "missing", 1), ("sscd", "shape", 1),
    ("dns_cg", "ok", 0), ("dns_fg_bin", "missing", 1),
])
def test_probe_exit_codes_match_jax(monkeypatch, capsys, model, case, code):
    monkeypatch.setattr(jax_adapt, "_expected_shapes", _jax_expected_shapes)
    if model == "sscd":
        state = _sscd_state(case)
    else:
        net = (TorchCoarseStudent() if model == "dns_cg"
               else ScriptableFineStudent("bin"))
        state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
        if case == "missing":
            del state["binarization.W"]
    args = argparse.Namespace(model=model)
    assert jax_adapt.probe(args, state) == code
    jax_out = capsys.readouterr().out
    assert torch_adapt.probe(args, state) == code
    torch_out = capsys.readouterr().out
    first = {"ok": "OK: all" if model == "sscd" else "no init reference",
             "missing": "CONVERSION WOULD FAIL", "shape": "SHAPE DISAGREEMENT"}[case]
    assert first in jax_out and first in torch_out
    # The same artifact report: key groups and alias renames.
    assert torch_out.split("\n")[:3] == jax_out.split("\n")[:3]


def test_probe_cli_exits_with_its_code(torchscripts):
    args = torch_adapt.parser.parse_args(
        ["--input_torchscript", torchscripts["dns_cg"], "--model", "dns_cg", "--probe"])
    assert args.device == "cuda"  # the card unless --device cpu
    with pytest.raises(SystemExit) as exc:
        torch_adapt.main(args)
    assert exc.value.code == 0
