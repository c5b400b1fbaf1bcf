#!/usr/bin/env python3
"""Convert published torch weights to npz checkpoints on the PyTorch/CUDA
port (counterpart of ``vsc2022_tpu/baseline/adapt_model.py``, with the same
flags plus ``--device``).

    python -m vsc2022_torch.baseline.adapt_model --input_torchscript sscd.pt \\
        --output_checkpoint sscd.npz [--model sscd] [--verify] [--device cuda]

The checkpoint written is the JAX package's: the Flax variable tree as one
npz with '/'-joined keys (``utils/checkpoint.save_variables``), the same
arrays as the JAX package's ``adapt_model`` writes for the same
TorchScript file. ``--checkpoint_path`` reads it in both packages.

Conversion goes through the port's own models: the TorchScript state dict
is normalized onto the port's names (``convert``: wrapper prefixes, the
alias rules), the entries a fresh port model of ``--model`` holds are taken
(a missing one raises ``ConversionKeyError`` with the closest names), and
the tree is written by ``convert.sscd_to_jax``, ``dino_vit_to_jax`` or
``dns_student_to_jax``.

``--verify`` runs the TorchScript model on the CPU, as the reference runs
it, loads the written tree back into the port's model on ``--device`` (the
card unless ``--device cpu``; float32 without TF32, deterministic
algorithms) and compares their outputs on random input: squared distance
at most 1e-3 per sample (the reference's check, adapt_sscd_model.py:44-51;
64x64 images for SSCD and DINO, 3 frames of 9 unit 3840-d regions for the
DnS students). ``--probe`` writes nothing: it prints the artifact's key
groups, the alias renames and the shape agreement with a fresh port model,
and exits 0, or 1 where the conversion would fail or a shape disagrees.
"""

import argparse
import logging
import os
from collections import Counter

import numpy as np

logger = logging.getLogger("adapt_model")

parser = argparse.ArgumentParser()
parser.add_argument(
    "--input_torchscript", type=str, required=True,
    help="Path to the torch model to convert.",
)
parser.add_argument(
    "--output_checkpoint", type=str, default=None,
    help="The Flax npz checkpoint to write (required unless --probe).",
)
parser.add_argument(
    "--probe", action="store_true",
    help="Dry run: print the artifact's serialized key groups, the alias "
    "renames the converter applies, and per-parameter shape agreement "
    "against a fresh port model, without writing a checkpoint. On a "
    "missing key, prints the unmet requirement next to the closest "
    "serialized names (the fix is one ALIAS_RULES entry in "
    "vsc2022_torch/convert.py).",
)
parser.add_argument(
    "--model",
    choices=["sscd", "dino", "dns_cg", "dns_fg_att", "dns_fg_bin"],
    default="sscd",
)
parser.add_argument(
    "--strip_prefix", default="",
    help="Leading module prefix to strip from serialized parameter "
    "names (e.g. 'student.').",
)
parser.add_argument(
    "--verify", action="store_true",
    help="Numerically compare the torch artifact with the converted "
    "checkpoint in the port's model on random input.",
)
parser.add_argument(
    "--device", type=str, default="cuda", choices=("cuda", "cpu"),
    help="Device of --verify's port model (default cuda; raises when no "
    "GPU is present).",
)


def _student(model: str):
    """(student_type, fg_type) of a dns_* choice."""
    _, student_type, *fg = model.split("_")  # dns_cg / dns_fg_att / dns_fg_bin
    return student_type, fg[0] if fg else "att"


def port_module(model: str):
    """A fresh port model of the --model choice (default init)."""
    from vsc2022_torch.models.dns import CoarseStudentModule, FineGrainedStudentModule
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.models.vit import DinoViT

    if model == "sscd":
        return SSCDModel()
    if model == "dino":
        return DinoViT()
    student_type, fg_type = _student(model)
    if student_type == "cg":
        return CoarseStudentModule()
    return FineGrainedStudentModule(fg_type)


def _to_tree(model: str, state) -> dict:
    """The Flax variable tree of a port model's state dict."""
    from vsc2022_torch import convert

    if model == "sscd":
        return convert.sscd_to_jax(state)
    if model == "dino":
        return convert.dino_vit_to_jax(state)
    return convert.dns_student_to_jax(state, *_student(model))


def convert_state(model: str, state) -> dict:
    """TorchScript state dict (numpy arrays) → the Flax variable tree of
    the --model choice. Raises ``ConversionKeyError`` on a missing key."""
    import torch

    from vsc2022_torch import convert

    family = model.split("_")[0]
    named = {"sscd": convert.sscd_from_torch, "dino": convert.dino_vit_from_torch,
             "dns": convert.dns_student_from_torch}[family](state)
    with torch.device("meta"):
        keys_of = port_module(model)
    return _to_tree(model, convert.module_state(named, keys_of))


def _shape_tree(variables) -> dict:
    """{'params/backbone/conv1/kernel': (h, w, i, o), ...}"""
    from vsc2022_torch.utils.checkpoint import _flatten

    return {k: tuple(v.shape) for k, v in _flatten(variables).items()}


def _expected_shapes(model: str):
    """The shape tree of a fresh port model's checkpoint (None for the DnS
    students, whose parameters are construction inputs, as in JAX)."""
    if model.startswith("dns_"):
        return None
    return _shape_tree(_to_tree(model, port_module(model).state_dict()))


def probe(args, state) -> int:
    """Report what conversion WOULD do: artifact tree → alias-normalized
    names → converted tree → shape agreement. Returns an exit code."""
    from vsc2022_torch.convert import ConversionKeyError, apply_aliases

    family = "dns" if args.model.startswith("dns_") else args.model
    normalized = apply_aliases(state, family)
    renames = {}
    for old in state:
        (new,) = apply_aliases({old: state[old]}, family)
        if new != old:
            renames[old] = new

    groups = Counter(k.split(".")[0] for k in state)
    print(f"Artifact: {len(state)} parameters; top-level groups:")
    for name, count in sorted(groups.items()):
        print(f"  {name:<24} x{count}")
    if renames:
        print(f"Alias rules ({family}) rename {len(renames)} keys, e.g.:")
        for old in sorted(renames)[:5]:
            print(f"  {old} -> {renames[old]}")
    else:
        print(f"Alias rules ({family}): no renames needed")

    try:
        variables = convert_state(args.model, state)
    except ConversionKeyError as exc:
        print(f"CONVERSION WOULD FAIL: {exc}")
        print("Serialized keys after alias normalization (first 40):")
        for k in sorted(normalized)[:40]:
            print(f"  {k}  {tuple(normalized[k].shape)}")
        return 1

    got = _shape_tree(variables)
    expected = _expected_shapes(args.model)
    if expected is None:
        print(f"Converted tree: {len(got)} parameters (DnS students have "
              "no init reference; shapes below)")
        for name in sorted(got):
            print(f"  {name:<56} {got[name]}")
        return 0
    bad = sorted(
        set(expected) ^ set(got)
        | {n for n in set(expected) & set(got) if expected[n] != got[n]}
    )
    if bad:
        print(f"SHAPE DISAGREEMENT on {len(bad)} parameters:")
        for name in bad[:40]:
            print(f"  {name:<56} artifact={got.get(name)} model={expected.get(name)}")
        return 1
    print(f"OK: all {len(got)} parameters map with matching shapes")
    return 0


def verify(args, variables) -> float:
    """The TorchScript model on the CPU against the port's model loaded
    from ``variables`` on ``--device``, on random input (the JAX package's
    inputs and rule). Returns the largest squared distance; raises above
    1e-3."""
    import torch

    from vsc2022_torch import convert
    from vsc2022_torch.device import resolve_device
    from vsc2022_torch.inference.pipeline import f32_numerics

    device = resolve_device(args.device)
    torch_model = torch.jit.load(args.input_torchscript, map_location="cpu").eval()
    rng = np.random.RandomState(0)
    with torch.no_grad(), f32_numerics(device):
        if args.model.startswith("dns_"):
            from vsc2022_torch.models.dns import DnSStudent

            student_type, fg_type = _student(args.model)
            student = DnSStudent(
                student_type, fg_type if student_type == "fg" else None,
                state_dict=convert.dns_student_from_jax(variables, student_type, fg_type),
                device=device,
            )
            regions = rng.randn(3, 9, 3840).astype(np.float32)
            regions /= np.linalg.norm(regions, axis=-1, keepdims=True)
            x = torch.from_numpy(regions)
            # The reference feeds cg an unsqueezed dim (dns_index.py:110-111).
            expect = torch_model.index_video(x.unsqueeze(1) if student_type == "cg" else x)
            got = student.index_video(regions.reshape(regions.shape[0], -1))
            expect = expect.numpy().reshape(got.shape)
        else:
            x = rng.randn(2, 3, 64, 64).astype(np.float32)
            expect = torch_model(torch.from_numpy(x)).numpy()
            from_jax = convert.sscd_from_jax if args.model == "sscd" else convert.dino_vit_from_jax
            model = convert.load_into(port_module(args.model), from_jax(variables))
            model = model.to(device).eval()
            got = model(torch.from_numpy(x).to(device)).cpu().numpy()
    dist = ((got - expect) ** 2).reshape(got.shape[0], -1).sum(axis=1)
    if (dist > 1e-3).any():
        raise Exception(f"Conversion mismatch: max squared distance {dist.max():.2e}")
    logger.info(f"Verified on {device}: outputs match within tolerance "
                f"(max squared distance {dist.max():.2e})")
    return float(dist.max())


def main(args):
    from vsc2022_torch.convert import load_torchscript_state
    from vsc2022_torch.utils.checkpoint import save_variables

    if not getattr(args, "probe", False):
        if not args.output_checkpoint:
            raise Exception("--output_checkpoint is required (or use --probe)")
        if os.path.exists(args.output_checkpoint):
            raise Exception("Output file already exists")

    state = load_torchscript_state(args.input_torchscript, strip_prefix=args.strip_prefix)
    if getattr(args, "probe", False):
        raise SystemExit(probe(args, state))
    variables = convert_state(args.model, state)
    if args.verify:
        verify(args, variables)
    save_variables(args.output_checkpoint, variables)
    logger.info(f"Wrote {args.output_checkpoint}")


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
