"""Carry state from the JAX package into the port, and back.

Every ``*_from_jax`` function takes plain values (numpy arrays, dicts),
so this module imports nothing of JAX: the caller converts first, e.g.
``np.asarray(jax_searcher._refs)``, ``jax_params._asdict()`` or a Flax
variable tree mapped through ``np.asarray`` (``load_variables`` reads the
JAX package's npz trees as such). The descriptor models also load
TorchScript state dicts (``load_torchscript_state``). The trainers write
their checkpoints as the JAX package's npz trees (``sscd_to_jax``,
``dns_student_to_jax``), so a checkpoint either package writes loads in
the other.
"""

from __future__ import annotations

import difflib
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.ops.similarity import SimilaritySearcher
from vsc2022_torch.ops.tn_align import TNParams


def searcher_from_arrays(
    refs: np.ndarray,
    n_valid: int,
    ref_sq: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
    metric: str = "IP",
    precision: str = "highest",
) -> SimilaritySearcher:
    """The port's searcher over the corpus a JAX ``SimilaritySearcher``
    stages: ``refs`` its padded ``_refs`` [N_pad, D], ``n_valid`` its
    ``_n_valid``, ``ref_sq`` its ``_ref_sq``, ``metric`` and ``precision``
    its own. Under "IP" an f32 or bf16 corpus's ``ref_sq`` is all zeros
    (anything else there is an L2 corpus, and raises). Under "L2" the
    ``ref_sq`` holds the rows' squared norms, which the port's searcher
    takes as they are, so the two score every pair on the same norms.

    An int8 corpus (int8 ``refs``, IP only) carries its per-row scales in
    the ``ref_sq`` slot: its codes and scales are staged as they are
    (``SimilaritySearcher.from_int8``), not quantized again.

    A bf16 corpus arrives as an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` refuses: its bits are read through a 16-bit
    integer view and widened to f32, which is exact, and the searcher
    rounds them back to bf16, which returns the same bits (a bf16 value
    rounds to itself), so the corpus stages bit for bit. An f32 corpus
    at "default" stages in bf16, as the port's searcher stages it."""
    refs = np.asarray(refs)
    n_valid = int(n_valid)
    if refs.ndim != 2 or not 0 <= n_valid <= refs.shape[0]:
        raise ValueError(f"refs {refs.shape} with n_valid {n_valid}")
    if refs.dtype == np.int8:
        if ref_sq is None or np.asarray(ref_sq).shape != (refs.shape[0],):
            raise ValueError("an int8 corpus needs its scales (ref_sq) [N_pad]")
        if metric != "IP":
            raise NotImplementedError("int8 storage supports metric='IP' only")
        return SimilaritySearcher.from_int8(
            refs[:n_valid], np.asarray(ref_sq)[:n_valid], device=device,
            precision=precision,
        )
    if metric == "IP" and ref_sq is not None and np.any(np.asarray(ref_sq) != 0):
        raise ValueError(
            "a non-zero ref_sq beside f32 or bf16 rows means an L2 corpus: "
            "pass metric='L2'"
        )
    if metric == "L2" and (ref_sq is None or np.asarray(ref_sq).shape != (refs.shape[0],)):
        raise ValueError("an L2 corpus needs its squared norms (ref_sq) [N_pad]")
    if refs.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(refs[:n_valid]).view(np.int16))
        rows, dtype = bits.view(torch.bfloat16).float().numpy(), "bfloat16"
    elif refs.dtype == np.float32:
        rows, dtype = refs[:n_valid], "float32"
    else:
        raise NotImplementedError(
            f"{refs.dtype} corpora are not ported yet (float32, bfloat16 and int8 only)"
        )
    searcher = SimilaritySearcher(rows, metric=metric, precision=precision,
                                  dtype=dtype, device=device)
    if metric == "L2":
        # JAX's norms, as they are (its sum may round otherwise than _row_sq).
        searcher._ref_sq[:n_valid] = torch.from_numpy(
            np.array(ref_sq[:n_valid], dtype=np.float32)).to(searcher.device)
    return searcher


def tn_params_from_jax(params: Mapping) -> TNParams:
    """The port's ``TNParams`` from a JAX ``TNParams._asdict()``."""
    unknown = set(params) - set(TNParams._fields)
    if unknown:
        raise ValueError(f"unknown TN parameters: {sorted(unknown)}")
    return TNParams(**dict(params))


def dns_student_from_jax(
    variables: Mapping, student_type: str, fg_type: str = "att"
) -> Dict[str, np.ndarray]:
    """The port's DnS student state dict (numpy arrays, torch names) from
    a Flax ``DnSStudent`` variable tree ``{"params": {"reduction":
    {"kernel", "bias"}, "attention": {"context"}, "rotation"?,
    "project"?}}``, as ``save_variables`` writes it. Dense kernels
    [in, out] become Linear weights [out, in]; the context [512, 1]
    becomes ``attention.context_vector.weight`` [1, 512]; the rotation is
    used as ``x @ W`` on both sides, so it is taken as it is."""
    if student_type not in ("cg", "fg"):
        raise ValueError(f"student_type must be cg|fg, got {student_type!r}")
    params = variables["params"]

    def arr(x):
        return np.asarray(x, dtype=np.float32)

    state = {
        "reduction.weight": arr(params["reduction"]["kernel"]).T.copy(),
        "reduction.bias": arr(params["reduction"]["bias"]),
        "attention.context_vector.weight": arr(params["attention"]["context"]).T.copy(),
    }
    if student_type == "cg":
        state["project.weight"] = arr(params["project"]["kernel"]).T.copy()
        state["project.bias"] = arr(params["project"]["bias"])
    elif fg_type == "bin":
        state["binarization.W"] = arr(params["rotation"])
    return state


# ---- descriptor models ------------------------------------------------------
#
# Published weights come as TorchScript (``--torchscript_path``) or as the
# JAX package's npz variable trees (``--checkpoint_path``, written by
# ``utils/checkpoint.save_variables``). The port's models use torch's own
# names, so a TorchScript state dict needs only the JAX package's key
# normalization (its wrapper prefixes and alias rules, copied here), and a
# Flax tree is relaid: conv kernels HWIO → OIHW, Dense [in, out] → Linear
# [out, in], BatchNorm scale / bias / mean / var → weight / bias /
# running_mean / running_var, and the attention's per-head DenseGeneral
# kernels → the fused qkv and the out projection.

StateDict = Dict[str, np.ndarray]

# Wrapper prefixes that carry no architecture information: stripped when
# EVERY key shares one (DataParallel, generic containers, torch.compile,
# DnS's student attribute).
_WRAPPER_PREFIXES = ("module.", "model.", "net.", "student.", "_orig_mod.")

# Known serialized-layout variants → the canonical names (the JAX package's
# models/convert.py ALIAS_RULES; the DnS students' rules serve
# ``dns_student_from_torch``, whose entry points load students as
# TorchScript modules otherwise): anchored regex rewrites applied per key
# until none matches, so no rule may produce text its own pattern matches.
ALIAS_RULES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "sscd": (
        (r"^trunk\.", "backbone."),
        (r"^encoder\.", "backbone."),
        (r"^embeddings\.1\.", "project."),
        (r"^embedding_projection\.", "project."),
        (r"^(backbone\.)?initial_block\._module\.0\.", r"\g<1>conv1."),
        (r"^(backbone\.)?initial_block\._module\.1\.", r"\g<1>bn1."),
    ),
    "dino": (
        (r"^backbone\.", ""),
        (r"^encoder\.", ""),
    ),
    "dns": (
        (r"^(cg|fg_att|fg_bin)_student\.", ""),
        (r"^attention\.context\.(?=weight)", "attention.context_vector."),
    ),
}


def apply_aliases(state: StateDict, family: str) -> StateDict:
    """Rewrite the known alternative names of ``family`` (ALIAS_RULES) onto
    the canonical layout. Idempotent; unknown names pass through, so the
    closest-key diagnosis of ``_require`` still fires for new layouts."""
    rules = ALIAS_RULES.get(family, ())
    out: StateDict = {}
    for key, value in state.items():
        changed = True
        while changed:
            changed = False
            for pattern, repl in rules:
                new_key = re.sub(pattern, repl, key)
                if new_key != key:
                    key, changed = new_key, True
        out[key] = value
    return out


class ConversionKeyError(KeyError):
    """A converter needed a parameter name the artifact doesn't have."""


def _require(state: StateDict, name: str) -> np.ndarray:
    """state[name], or an error naming the closest keys the artifact has:
    a real artifact that nests its modules otherwise needs a key-mapping
    tweak, and the near misses show which."""
    if name in state:
        return state[name]
    near = difflib.get_close_matches(name, state.keys(), n=5, cutoff=0.4)
    raise ConversionKeyError(
        f"Parameter {name!r} not found in the checkpoint. "
        f"Closest serialized names: {near or sorted(state)[:5]}. "
        "If the artifact nests its modules differently, add an alias rule "
        "in vsc2022_torch/convert.py (ALIAS_RULES)."
    )


def normalize_state_keys(state: StateDict) -> StateDict:
    """Strip uniform wrapper prefixes (module./model./student./...) until
    none applies. Only a prefix shared by EVERY key goes, so names that
    carry architecture ('backbone.*' beside 'project.*') stay."""
    while state:
        for prefix in _WRAPPER_PREFIXES:
            if all(k.startswith(prefix) for k in state):
                state = {k[len(prefix):]: v for k, v in state.items()}
                break
        else:
            return state
    return state


def load_torchscript_state(path: str, strip_prefix: str = "") -> StateDict:
    """A TorchScript file's state dict as numpy arrays: ``strip_prefix``
    (an artifact's own nesting, e.g. 'student.') cut from the names that
    start with it, then uniform wrapper prefixes stripped."""
    module = torch.jit.load(path, map_location="cpu")
    state = {}
    for name, t in module.state_dict().items():
        if strip_prefix and name.startswith(strip_prefix):
            name = name[len(strip_prefix):]
        state[name] = t.detach().cpu().numpy()
    return normalize_state_keys(state)


def sscd_from_torch(state: StateDict) -> StateDict:
    """An SSCD state dict in the port's names: the adapted layout
    (``backbone.*`` + ``project.*``, reference:
    vsc/baseline/adapt_sscd_model.py:59-69) after ALIAS_RULES["sscd"], or
    bare torchvision names with the head in ``fc.*``."""
    state = apply_aliases(state, "sscd")
    if any(k.startswith("backbone.") for k in state):
        return state
    return {("project." + k[3:] if k.startswith("fc.") else "backbone." + k): v
            for k, v in state.items()}


def dino_vit_from_torch(state: StateDict) -> StateDict:
    """A DINO ViT state dict in the port's names (DINO's own, after
    ALIAS_RULES["dino"])."""
    return apply_aliases(state, "dino")


def dns_student_from_torch(state: StateDict) -> StateDict:
    """A DnS student's state dict in the port's names (the
    distill-and-select layout, the port's student modules' own, after
    ALIAS_RULES["dns"]): ``reduction.*``, ``attention.context_vector.weight``,
    fg bin's ``binarization.W``, cg's ``project.*``."""
    return apply_aliases(state, "dns")


def module_state(state: StateDict, model: torch.nn.Module) -> StateDict:
    """The entries of ``state`` (the port's names) that ``model`` holds,
    each required (``_require``: a missing one raises
    ``ConversionKeyError`` naming the closest keys), less BatchNorm's
    ``num_batches_tracked`` counters; entries the model lacks (a
    classifier head) are left out. ``model`` may live on the meta device."""
    return {key: _require(state, key) for key in model.state_dict()
            if not key.endswith("num_batches_tracked")}


def load_into(model: torch.nn.Module, state: StateDict) -> torch.nn.Module:
    """Load ``state`` (numpy arrays or tensors, the port's names) into
    ``model``: every parameter and buffer must be there (``_require``),
    except BatchNorm's ``num_batches_tracked`` counters, which inference
    never reads; keys the model lacks (a classifier head) are ignored."""
    own = model.state_dict()
    new = {}
    for key, value in own.items():
        if key.endswith("num_batches_tracked") and key not in state:
            new[key] = value
            continue
        got = torch.as_tensor(np.array(_require(state, key)))
        if tuple(got.shape) != tuple(value.shape):
            raise ValueError(f"{key}: the checkpoint has shape {tuple(got.shape)}, "
                             f"the model {tuple(value.shape)}")
        new[key] = got.to(value.dtype)
    model.load_state_dict(new)
    return model


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv_from_jax(node: Mapping, prefix: str, out: StateDict) -> None:
    out[prefix + "weight"] = np.ascontiguousarray(_f32(node["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in node:
        out[prefix + "bias"] = _f32(node["bias"])


def _bn_from_jax(params: Mapping, stats: Mapping, prefix: str, out: StateDict) -> None:
    out[prefix + "weight"] = _f32(params["scale"])
    out[prefix + "bias"] = _f32(params["bias"])
    out[prefix + "running_mean"] = _f32(stats["mean"])
    out[prefix + "running_var"] = _f32(stats["var"])


_BLOCK_NAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _resnet_from_jax(params: Mapping, stats: Mapping, prefix: str) -> StateDict:
    """The port's ResNet50 names from a Flax ResNet50 tree (unfolded, with
    its ``batch_stats``, or folded: convs with biases and no norms)."""
    out: StateDict = {}

    def module(node, st, at):
        if "kernel" in node:
            _conv_from_jax(node, at, out)
        else:
            _bn_from_jax(node, st, at, out)

    for name, node in params.items():
        if name.startswith("layer"):  # layer{s}_{b}
            stage, block = name.split("_")
            for sub, leaf in node.items():
                at = f"{prefix}{stage}.{block}.{_BLOCK_NAMES.get(sub, sub)}."
                module(leaf, stats.get(name, {}).get(sub), at)
        else:  # the stem's conv1 / bn1
            module(node, stats.get(name), f"{prefix}{name}.")
    return out


def sscd_from_jax(variables: Mapping) -> StateDict:
    """The port's ``SSCDModel`` state dict from a Flax ``SSCDModel``
    variable tree (as ``save_variables`` writes it; folded trees too)."""
    params = variables["params"]
    out = _resnet_from_jax(params["backbone"],
                           variables.get("batch_stats", {}).get("backbone", {}),
                           "backbone.")
    out["project.weight"] = np.ascontiguousarray(_f32(params["project"]["kernel"]).T)
    out["project.bias"] = _f32(params["project"]["bias"])
    return out


def l3imac_from_jax(variables: Mapping) -> StateDict:
    """The port's ``L3iMACExtractor`` state dict from a Flax
    ``L3iMACExtractor`` variable tree."""
    return _resnet_from_jax(variables["params"]["backbone"],
                            variables.get("batch_stats", {}).get("backbone", {}),
                            "backbone.")


def dino_vit_from_jax(variables: Mapping) -> StateDict:
    """The port's ``DinoViT`` state dict from a Flax ``DinoViT`` variable
    tree: the q, k and v DenseGeneral kernels [dim, heads, head_dim] stack
    into ``attn.qkv`` [3·dim, dim], the out kernel [heads, head_dim, dim]
    becomes ``attn.proj`` [dim, dim]."""
    params = variables["params"]
    out: StateDict = {}

    def dense(node, at):
        out[at + "weight"] = np.ascontiguousarray(_f32(node["kernel"]).T)
        out[at + "bias"] = _f32(node["bias"])

    def norm(node, at):
        out[at + "weight"] = _f32(node["scale"])
        out[at + "bias"] = _f32(node["bias"])

    _conv_from_jax(params["patch_embed"], "patch_embed.proj.", out)
    out["cls_token"] = _f32(params["cls_token"])
    out["pos_embed"] = _f32(params["pos_embed"])
    norm(params["norm"], "norm.")
    i = 0
    while f"block{i}" in params:
        node, at = params[f"block{i}"], f"blocks.{i}."
        norm(node["norm1"], at + "norm1.")
        norm(node["norm2"], at + "norm2.")
        dense(node["mlp"]["fc1"], at + "mlp.fc1.")
        dense(node["mlp"]["fc2"], at + "mlp.fc2.")
        attn = node["attn"]
        dim = _f32(attn["query"]["kernel"]).shape[0]
        out[at + "attn.qkv.weight"] = np.ascontiguousarray(np.concatenate(
            [_f32(attn[k]["kernel"]).reshape(dim, -1).T for k in ("query", "key", "value")]))
        out[at + "attn.qkv.bias"] = np.concatenate(
            [_f32(attn[k]["bias"]).reshape(-1) for k in ("query", "key", "value")])
        out[at + "attn.proj.weight"] = np.ascontiguousarray(
            _f32(attn["out"]["kernel"]).reshape(-1, dim).T)
        out[at + "attn.proj.bias"] = _f32(attn["out"]["bias"])
        i += 1
    return out


# ---- back to Flax trees (the trainers' checkpoints) ---------------------------


def _tensor_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


_BLOCK_NAMES_TO_JAX = {v: k for k, v in _BLOCK_NAMES.items()}
_BN_TO_JAX = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def sscd_to_jax(state: Mapping) -> Dict[str, dict]:
    """The inverse of ``sscd_from_jax``: a Flax ``SSCDModel`` variable tree
    ``{"params", "batch_stats"}`` (numpy float32; ``save_variables`` writes
    it as the JAX package's checkpoints) from the port's ``SSCDModel``
    state dict (tensors or arrays; folded trunks too). Conv weights OIHW →
    HWIO kernels, Linear [out, in] → Dense [in, out], BatchNorm weight /
    bias / running_mean / running_var → scale / bias / mean / var;
    ``num_batches_tracked`` has no counterpart and is left out."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}

    def put(collection, path, value):
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    for key, value in state.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        arr = _tensor_np(value)
        if parts[0] == "project":
            put("params", ["project", "kernel" if parts[1] == "weight" else "bias"],
                np.ascontiguousarray(arr.T) if parts[1] == "weight" else arr)
            continue
        if parts[0] != "backbone":
            raise ValueError(f"not an SSCDModel key: {key}")
        if parts[1].startswith("layer"):  # backbone.layer{s}.{b}.<module>.<leaf>
            head, rest = f"{parts[1]}_{parts[2]}", parts[3:]
            if rest[0] == "downsample":
                rest = [_BLOCK_NAMES_TO_JAX[f"downsample.{rest[1]}"], rest[2]]
            path = ["backbone", head, rest[0]]
        else:  # the stem's conv1 / bn1
            path, rest = ["backbone", parts[1]], parts[2:]
        leaf = rest[-1]
        if arr.ndim == 4:
            put("params", path + ["kernel"], np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        elif path[-1].startswith("conv") or path[-1] == "downsample_conv":
            put("params", path + ["bias"], arr)  # a folded trunk's conv bias
        else:
            collection, name = _BN_TO_JAX[leaf]
            put(collection, path + [name], arr)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def dns_student_to_jax(state: Mapping, student_type: str, fg_type: str = "att"
                       ) -> Dict[str, dict]:
    """The inverse of ``dns_student_from_jax``: a Flax student variable
    tree ``{"params": ...}`` (numpy float32; the JAX package's distillation
    checkpoints) from the port's student state dict."""
    if student_type not in ("cg", "fg"):
        raise ValueError(f"student_type must be cg|fg, got {student_type!r}")
    params: Dict[str, dict] = {
        "reduction": {"kernel": np.ascontiguousarray(_tensor_np(state["reduction.weight"]).T),
                      "bias": _tensor_np(state["reduction.bias"])},
        "attention": {"context": np.ascontiguousarray(
            _tensor_np(state["attention.context_vector.weight"]).T)},
    }
    if student_type == "cg":
        params["project"] = {"kernel": np.ascontiguousarray(_tensor_np(state["project.weight"]).T),
                             "bias": _tensor_np(state["project.bias"])}
    elif fg_type == "bin":
        params["rotation"] = _tensor_np(state["binarization.W"])
    return {"params": params}


def dino_vit_to_jax(state: Mapping, num_heads: int = 6) -> Dict[str, dict]:
    """The inverse of ``dino_vit_from_jax``: a Flax ``DinoViT`` variable
    tree ``{"params": ...}`` (numpy float32, as the JAX package's
    ``dino_vit_from_torch`` writes it) from the port's ``DinoViT`` state
    dict: the fused ``attn.qkv`` [3·dim, dim] splits into the query, key
    and value DenseGeneral kernels [dim, heads, head_dim] and biases
    [heads, head_dim], ``attn.proj`` [dim, dim] becomes the out kernel
    [heads, head_dim, dim], conv weights OIHW → HWIO kernels, Linear
    [out, in] → Dense [in, out], LayerNorm weight → scale."""

    def arr(key):
        return _tensor_np(state[key])

    def dense(at):
        return {"kernel": np.ascontiguousarray(arr(at + "weight").T), "bias": arr(at + "bias")}

    def norm(at):
        return {"scale": arr(at + "weight"), "bias": arr(at + "bias")}

    params: Dict[str, dict] = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(arr("patch_embed.proj.weight").transpose(2, 3, 1, 0)),
            "bias": arr("patch_embed.proj.bias"),
        },
        "cls_token": arr("cls_token"),
        "pos_embed": arr("pos_embed"),
        "norm": norm("norm."),
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in state:
        at = f"blocks.{i}."
        qkv_w, qkv_b = arr(at + "attn.qkv.weight"), arr(at + "attn.qkv.bias")
        dim = qkv_w.shape[1]
        head_dim = dim // num_heads
        attn = {
            name: {
                "kernel": np.ascontiguousarray(
                    qkv_w[j * dim : (j + 1) * dim].T.reshape(dim, num_heads, head_dim)),
                "bias": qkv_b[j * dim : (j + 1) * dim].reshape(num_heads, head_dim),
            }
            for j, name in enumerate(("query", "key", "value"))
        }
        attn["out"] = {
            "kernel": np.ascontiguousarray(
                arr(at + "attn.proj.weight").T.reshape(num_heads, head_dim, dim)),
            "bias": arr(at + "attn.proj.bias"),
        }
        params[f"block{i}"] = {
            "norm1": norm(at + "norm1."), "attn": attn, "norm2": norm(at + "norm2."),
            "mlp": {"fc1": dense(at + "mlp.fc1."), "fc2": dense(at + "mlp.fc2.")},
        }
        i += 1
    return {"params": params}
