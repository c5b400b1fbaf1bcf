"""Resident retrieval server on the PyTorch/CUDA port: stage the corpus
once, serve query batches at search speed.

Counterpart of ``vsc2022_tpu/retrieval/serve.py``, with the same flags
plus ``--device`` (``cuda`` unless ``--device cpu`` or ``cuda:N`` is
given; asking for CUDA where there is none raises) and ``--dist_backend``
(a pod's collectives). The reference has no serving story:
every eval invocation reloads the reference corpus and rebuilds its
FAISS index (reference: vsc/descriptor_eval_lib.py:27-60). This process
stages the corpus on the device once; each request runs the standard
candidate protocol (global top-k over all frame pairs, max-score
aggregation, per-query budgets; vsc/descriptor_eval_lib.py:23-24) and
writes a candidates CSV.

* ``--bf16`` (the default) stages the search corpus, the noise corpus and
  the localizer's reference tables in bfloat16 (half the device memory;
  scores at bf16 resolution, f32 accumulation); ``--f32`` opts out, for
  bit parity with the batch drivers' default; ``--int8`` stages the search
  and noise corpora as SQ8-style int8 codes with per-row scales (a quarter
  of f32's memory; queries f32, search exact over the dequantized corpus)
  and keeps the localizer's tables in bf16, as the JAX server does.
* ``--score_norm_features``: the noise corpus stages beside the
  references and every request's CSLS bias is computed on the device
  (``ScoreNormalizedVideoIndex``).
* ``--matches``: after retrieval the TN localizer aligns the top
  ``--localize_per_query`` pairs per query (the sscd_baseline stage)
  and a matches CSV is written too. The localizer's reference rows stay
  on the device across requests.
* ``--ref_fine_features``: the DnS two-stage track. Retrieval runs on
  the staged coarse corpus (the score-normalized cg npz of dns_index),
  localization on the fused fine chamfer + coarse similarity (the
  dns_baseline stage). Requests carry two query files, coarse and fine.

Wire protocol (line-oriented, the same over stdin/stdout or, with
``--listen HOST:PORT``, over TCP):

    request:   <query_npz_path>[\\t<candidates_csv>[\\t<matches_csv>]]\\n
    DnS mode:  <query_coarse_npz>\\t<query_fine_npz>[\\t<candidates_csv>[\\t<matches_csv>]]\\n
    add refs:  add\\t<refs_npz>\\n   (DnS: add\\t<coarse_npz>\\t<fine_npz>\\n)
    remove:    remove\\t<video_id>[\\t<video_id>...]\\n
    save:      save\\t<refs_npz>\\n   (DnS: save\\t<coarse_npz>\\t<fine_npz>\\n)
    extract:   extract\\t<videos_dir>\\t<output_npz>\\n
    video in:  searchv\\t<videos_dir>[\\t<candidates_csv>[\\t<matches_csv>]]\\n
    stats:     stats\\n
    launches:  launches[\\treset]\\n   (the port's kernel launch counts, zeroed first with reset)
    response:  ok\\t<candidates_csv>\\t<n_pairs>\\t<seconds>\\n
         or:   ok\\t<candidates_csv>\\t<n_pairs>\\t<matches_csv>\\t<n_matches>\\t<seconds>\\n
         or:   ok\\tadded\\t<n_new_videos>\\t<seconds>\\n
         or:   ok\\tremoved\\t<n_videos>\\t<n_frame_rows>\\t<seconds>\\n
         or:   ok\\tsaved\\t<n_videos>\\t<refs_npz>[\\t<fine_npz>]\\t<seconds>\\n
         or:   ok\\textracted\\t<n_videos>\\t<n_frames>\\t<output_npz>\\t<seconds>\\n
         or:   ok\\tstats\\t<n_videos>\\t<n_frames>\\t<dtype>\\t<sharded>\\t<matches>\\n
         or:   ok\\tlaunches\\t<json {kernel: count}>\\n
    error:     error\\t<message>\\n        (the server keeps serving)
    startup:   ready\\t<n_ref_videos>\\t<stage_seconds>\\n

In-band forms (the payload bytes ride the request stream, length
prefixed, right after the header line; no shared filesystem needed):

    search:    searchb\\t<query_npz_len>[\\t<fine_npz_len>]\\n<bytes...>
    add refs:  addb\\t<refs_npz_len>[\\t<fine_npz_len>]\\n<bytes...>
    snapshot:  saveb\\n
    response:  okb\\t<n_pairs>\\t<cand_csv_len>[\\t<n_matches>\\t<match_csv_len>]\\t<seconds>\\n<bytes...>
         or:   okb\\t<n_videos>\\t<coarse_npz_len>[\\t<fine_npz_len>]\\t<seconds>\\n<bytes...>

Both request forms run the same retrieval/TN core, so in-band results
equal the path protocol's byte for byte. ``add`` grows the corpus on the
device (only the new rows cross to it; duplicate ids are rejected),
``remove`` compacts it there onto the layout a fresh server over the
survivors stages, and ``save`` snapshots the current reference set in
corpus row order, so a server restarted on the snapshot answers as the
live one did. A failed add, remove or save leaves the index and the
localizer agreeing. ``quit`` (or EOF) ends a session (one TCP client);
``shutdown`` stops the server. TCP sessions run one thread per client,
with requests serialized on one device lock; the parent's stdout gets
``listening\\t<host>:<port>`` with the bound port (``:0`` picks one).

End-to-end serving: with ``--baseline`` and its weights
(``--checkpoint_path`` or ``--torchscript_path``) a descriptor model stays
on the device beside the corpus, and requests can start from raw videos:
``extract`` decodes and embeds a video directory to a descriptor npz (one
inference CLI run without the per-run model start-up), and ``searchv``
embeds then searches in one request, the query descriptors never touching
disk. With the same weights and flags, ``extract`` writes the CLI's npz
byte for byte, and ``searchv`` answers as ``extract`` followed by a path
search of its npz. ``searchv`` does not serve the DnS track.

``--sharded`` shards the corpus over every device of the ``--device`` kind
in this process (``vsc2022_torch.parallel.corpus_mesh``: each card; one
shard on a one-card machine or on the CPU), and the localizer's reference
tables with it (``shard_ref_table``).

``--ivf NLIST`` lays the search corpus out in NLIST k-means cells, the IVF
pruned tier (``vsc2022_torch/ops/ivf.py``; 0: max(2, rows // 16384)), and
``--ivf_nprobe`` sets its probe width: focused requests scan a block subset,
and every answer stays the plain server's, ties included. Single-device:
with ``--sharded`` it raises the JAX server's ``ValueError``.

Multi-host pods: every rank runs this CLI with the same flags plus its
``--process_id``; ``--coordinator`` rendezvouses the ``torch.distributed``
group, so the ``--sharded`` corpus mesh spans every rank's device (one
rank a card: ``cuda`` takes the card ``process_id % device_count``, or
``--device cuda:N``). Rank 0 speaks the client protocol; every request it
accepts is first relayed verbatim to the follower ranks over the
``--control`` socket, so all ranks run the same collectives in the same
order (a collective entered by one rank alone would hang the pod).
Followers never write files (CSV and npz outputs are the leader's);
path-based commands assume a shared filesystem, while the in-band forms
(searchb/addb) need none: their payload bytes ride the relay. A follower
prints ``follower\t<rank>\t<stage_seconds>`` when it is staged, and logs
each reply it computes. The leader's exit (quit, shutdown, EOF) releases
the followers; a dead follower turns the next device request into an
error response. ``--dist_backend``: ``nccl`` between ranks on separate
cards (the default on cards), ``gloo`` on the CPU (its default) or where
ranks share a card (NCCL refuses two ranks on one card).

Not ported yet (answers ``error``): the ``probe`` command.

    python -m vsc2022_torch.retrieval.serve --ref_features refs.npz \\
        --score_norm_features noise.npz --matches [--listen 127.0.0.1:0]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import logging
import sys
import time

import numpy as np

from vsc2022_torch.device import device_flag, resolve_device
from vsc2022_torch.metrics import CandidatePair, Dataset, Match
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation, rank_candidates
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex, VideoIndex
from vsc2022_torch.retrieval.score_norm import l2_normalize_rows
from vsc2022_torch.storage import convert_to_dict, load_features, store_features
from vsc2022_torch.types import VideoFeature

logger = logging.getLogger("vsc2022_torch.serve")

parser = argparse.ArgumentParser(
    description="Resident retrieval server over stdin/stdout (PyTorch/CUDA port)"
)
parser.add_argument(
    "--ref_features", required=True,
    help="Reference descriptors npz, staged on the device once",
)
parser.add_argument(
    "--score_norm_features",
    help="Noise descriptors npz: serve score-normalized search",
)
parser.add_argument("--beta", type=float, default=1.2)
parser.add_argument(
    "--retrieval_per_query", type=int, default=1200,
    help="Frame-hit budget per query video (challenge protocol: 1200)",
)
parser.add_argument(
    "--pairs_per_query", type=int, default=25,
    help="Aggregated pair budget per query video (protocol: 25)",
)
parser.add_argument(
    "--sharded", action="store_true",
    help="Shard the reference corpus (and the localizer's reference tables) "
    "across every device of the --device kind in this process",
)
_dtype_group = parser.add_mutually_exclusive_group()
_dtype_group.add_argument(
    "--bf16", action="store_true",
    help="Store the corpus and the resident localizer ref tables in "
    "bfloat16 (similarities still accumulate in f32). The serving "
    "default: the flag is kept for compatibility.",
)
_dtype_group.add_argument(
    "--f32", action="store_true",
    help="Stage the corpus and localizer ref tables in float32: bit "
    "parity with the batch drivers' default, at twice the memory.",
)
_dtype_group.add_argument(
    "--int8", action="store_true",
    help="Stage the search corpus in symmetric per-row int8 (the FAISS SQ8 "
    "analog: a quarter of f32's memory; search exact over the dequantized "
    "corpus). The localizer's reference tables stay bfloat16.",
)
parser.add_argument(
    "--ivf", type=int, default=None, metavar="NLIST",
    help="Lay the search corpus out in NLIST k-means cells (the IVF pruned "
    "tier, ops/ivf.py; 0 = max(2, rows // 16384)): focused requests scan only "
    "the probed block subset, still exact, ties included. Single-device only "
    "(exclusive with --sharded).",
)
parser.add_argument(
    "--ivf_nprobe", type=int, default=None,
    help="Blocks probed per query row under --ivf (default 1/8 of the corpus "
    "blocks). Tunes speed, never the result.",
)
parser.add_argument(
    "--no_warmup", action="store_true",
    help="Skip the staging/kernel warm-up search before 'ready'",
)
parser.add_argument(
    "--matches", action="store_true",
    help="Also localize (TN alignment) and write a matches CSV",
)
parser.add_argument(
    "--localize_per_query", type=float, default=5,
    help="Pairs per query to localize (sscd_baseline budget: 5)",
)
parser.add_argument(
    "--vcsl_faithful_tn", action="store_true",
    help="Published VCSL TN parity mode for the localizer",
)
parser.add_argument(
    "--ref_fine_features",
    help="DnS fine reference npz: serve the DnS two-stage track. Requests "
    "then carry two query files: <coarse_npz>\\t<fine_npz>. Implies "
    "--matches; --ref_features must be the score-normalized coarse npz "
    "from dns_index",
)
parser.add_argument(
    "--fg_type", choices=["att", "bin"], default="att",
    help="DnS fine feature variant (bin rescales to ±1)",
)
parser.add_argument(
    "--listen",
    help="HOST:PORT: serve the same line protocol over TCP instead of "
    "stdin/stdout (port 0 binds a free port, reported on stdout as "
    "listening\\t<host>:<port>)",
)
parser.add_argument(
    "--device", default="cuda", type=device_flag,
    help="Device to serve on: cuda (the default; raises when no GPU is "
    "present; a pod's rank takes the card process_id %% device_count), "
    "cuda:N or cpu",
)
_multihost = parser.add_argument_group(
    "Multi-host",
    "Pod serving: every rank runs this CLI with the same flags (plus its "
    "--process_id); the corpus mesh spans all ranks' devices, rank 0 "
    "speaks the client protocol, and every device-touching request is "
    "relayed to the follower ranks over --control so the ranks stay in "
    "lockstep. Path-based commands need a shared filesystem; the in-band "
    "forms (searchb/addb) need none: their payload bytes are relayed "
    "verbatim. Requires --sharded.",
)
_multihost.add_argument(
    "--coordinator",
    help="HOST:PORT of the torch.distributed rendezvous (rank 0)",
)
_multihost.add_argument("--num_processes", type=int, default=1)
_multihost.add_argument("--process_id", type=int, default=0)
_multihost.add_argument(
    "--control",
    help="HOST:PORT of rank 0's request-relay socket (same value on every "
    "rank; rank 0 binds it, followers connect)",
)
_multihost.add_argument(
    "--dist_backend", choices=("nccl", "gloo"), default=None,
    help="The pod's collectives: nccl (the default on cards; one rank a "
    "card) or gloo (the default on the CPU; ranks that share a card)",
)
_extract = parser.add_argument_group(
    "Resident extraction",
    "Keep a descriptor model on the device beside the staged corpus, so "
    "requests can start from raw videos (`extract` decodes and embeds a "
    "video directory to npz; `searchv` embeds, then searches, in one "
    "request). Enabled by --baseline.",
)
_extract.add_argument(
    "--baseline", choices=["sscd", "dino", "dns"],
    help="Keep this descriptor model resident for extract/searchv requests "
    "(weights via --checkpoint_path/--torchscript_path)",
)
_extract.add_argument("--checkpoint_path",
                      help="npz variable tree for the resident --baseline model")
_extract.add_argument("--torchscript_path",
                      help="TorchScript weights for the resident --baseline model")
_extract.add_argument(
    "--extract_transforms", default="RESIZE_320_CENTER",
    help="InferenceTransforms preprocessing variant for the resident model "
    "(RESIZE_320_CENTER for SSCD, RESIZE_224_SQUARE for DINO)",
)
_extract.add_argument("--extract_batch_size", type=int, default=32)
_extract.add_argument("--extract_compute_dtype",
                      choices=["float32", "bfloat16"], default="float32",
                      help="bfloat16 runs the resident model's forward in bf16")
_extract.add_argument("--fold_bn", action="store_true",
                      help="Fold BatchNorm affines into the resident model's "
                      "convs (ResNet-family baselines)")
_extract.add_argument("--fps", type=float, default=1)
_extract.add_argument("--ffmpeg_path", default="ffmpeg")
_extract.add_argument("--video_extensions", default="mp4")


def staging_dtype(args) -> str:
    """The serving staging dtype: bfloat16 by default, as in the JAX
    server; ``--f32`` opts out, ``--int8`` stages SQ8 codes."""
    if args.int8:
        return "int8"
    return "float32" if args.f32 else "bfloat16"


def table_dtype(args) -> str:
    """The localizer's reference-table dtype, as the JAX server picks it:
    the staging dtype, except that int8 staging keeps bf16 tables (the
    alignment reads raw similarities; the corpus scales do not apply)."""
    dtype = staging_dtype(args)
    return "bfloat16" if dtype == "int8" else dtype


def check_multihost(args) -> bool:
    """The JAX server's checks of the pod flags; True in a pod."""
    if (args.num_processes or 1) <= 1:
        if args.coordinator or args.control or args.process_id:
            raise ValueError("--coordinator/--control/--process_id need "
                             "--num_processes > 1")
        return False
    if not args.coordinator:
        raise ValueError("--num_processes > 1 requires --coordinator host:port "
                         "(rank 0's torch.distributed rendezvous address)")
    if not args.control:
        raise ValueError("--num_processes > 1 requires --control host:port "
                         "(rank 0's request-relay socket)")
    if not args.sharded:
        raise ValueError("Multi-host serving shards the corpus over the pod "
                         "mesh: pass --sharded on every rank")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process_id {args.process_id} out of range "
                         f"[0, {args.num_processes})")
    return True


def build_index(args, device):
    refs = load_features(args.ref_features, Dataset.REFS)
    dim = refs[0].dimensions()
    dtype = staging_dtype(args)
    mesh = None
    if args.sharded:
        from vsc2022_torch.parallel import corpus_mesh

        mesh = corpus_mesh(device=device)
        logger.info(f"Sharding the corpus over {mesh}")
    codec = "Flat"
    if args.ivf is not None:
        # 0: the IVF tier with nlist from the corpus size, as the JAX server
        # picks it.
        n = args.ivf if args.ivf > 0 else max(
            2, sum(vf.feature.shape[0] for vf in refs) // 16384)
        codec = f"IVF{n}"
    kw = dict(dtype=dtype, device=device, mesh=mesh, codec_str=codec,
              ivf_nprobe=args.ivf_nprobe)
    if args.score_norm_features:
        noise = load_features(args.score_norm_features, Dataset.REFS)
        index = ScoreNormalizedVideoIndex(dim, noise, beta=args.beta, **kw)
    else:
        index = VideoIndex(dim, **kw)
    index.add(refs)
    return index, refs, dim


def build_localizer(index, refs, args, device):
    """Resident TN localizer over the (transformed) reference frames,
    with the sscd_baseline stage parameters (reference:
    vsc/baseline/sscd_baseline.py:117-135): score-normalized features use
    MaxSim over +0.5-biased similarity; raw features are L2-normalized
    and take the candidate's retrieval score. The DnS mode fuses the fine
    chamfer with the coarse similarity under MaxSim scoring (reference:
    vsc/baseline/dns_baseline.py:196-208)."""
    from vsc2022_torch.localization import (
        TNLocalizationCandidateScore,
        TNLocalizationMaxSim,
    )

    common = dict(model_type="TN", tn_max_step=5, min_length=4,
                  vcsl_faithful=args.vcsl_faithful_tn,
                  table_dtype=table_dtype(args), device=device,
                  mesh=index.mesh, shard_ref_table=index.mesh is not None)
    refs_loc = _localizer_refs(index, refs, args)
    if args.ref_fine_features:
        from vsc2022_torch.baseline.dns_baseline import DnSLocalization

        refs_fine = convert_to_dict(
            load_features(args.ref_fine_features, Dataset.REFS)
        )
        # The add path's coverage rule: every coarse video needs its fine
        # rows, or localization and save would fail on it much later.
        missing = [str(vf.video_id) for vf in refs if vf.video_id not in refs_fine]
        if missing:
            raise ValueError(
                f"Fine npz is missing reference videos: {missing[:5]} "
                "(coarse and fine sets must cover the same video ids)"
            )
        return DnSLocalization(
            {}, refs_fine, [], refs, fg_type=args.fg_type,
            similarity_bias=0.5, **common,
        )
    if args.score_norm_features:
        return TNLocalizationMaxSim([], refs_loc, similarity_bias=0.5, **common)
    return TNLocalizationCandidateScore([], refs_loc, **common)


def build_extractor(args, device):
    """The resident descriptor extractor for end-to-end serving: the model
    goes to the device once, at startup, so ``extract`` / ``searchv`` pay
    decode and forward only (the one-shot CLI loads the model per run;
    reference: vsc/baseline/inference_impl.py:173). Returns (extractor,
    reader_factory), or None without --baseline."""
    if not args.baseline:
        if args.checkpoint_path or args.torchscript_path:
            raise ValueError(
                "--checkpoint_path/--torchscript_path need --baseline "
                "to pick the model architecture"
            )
        return None
    if not (args.checkpoint_path or args.torchscript_path):
        raise ValueError(
            "A resident model needs weights: --checkpoint_path or "
            "--torchscript_path"
        )
    from functools import partial

    from vsc2022_torch.inference.cli import build_model
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import InferenceTransforms
    from vsc2022_torch.inference.video_reader import FFMpegVideoReader

    extractor = DescriptorExtractor(
        build_model(args),
        transform=InferenceTransforms[args.extract_transforms],
        batch_size=args.extract_batch_size,
        compute_dtype=args.extract_compute_dtype,
        device=device,
    )
    reader_factory = partial(
        FFMpegVideoReader, required_fps=args.fps, ffmpeg_path=args.ffmpeg_path,
    )
    return extractor, reader_factory


def _extract_feature_list(extractor_bundle, videos_path, args):
    """Decode and embed every video of a directory on the resident model,
    in sorted-filename order (the inference CLI's dataset contract:
    vsc/baseline/inference_impl.py:94-109)."""
    import os

    from vsc2022_torch.inference.pipeline import VideoDataset

    if extractor_bundle is None:
        raise ValueError(
            "No resident model: start the server with --baseline and "
            "--checkpoint_path to serve extract/searchv requests"
        )
    extractor, reader_factory = extractor_bundle
    if not os.path.isdir(videos_path):
        raise ValueError(f"Not a video directory: {videos_path}")
    dataset = VideoDataset(
        path=videos_path,
        reader_factory=reader_factory,
        extensions=args.video_extensions.split(","),
    )
    return list(extractor.extract(dataset))


def _extract_videos(extractor_bundle, parts, args, leader=True) -> str:
    """``extract``: embed a video directory to a descriptor npz on the
    resident model, one inference CLI run without its start-up. The npz
    is the leader's (a pod's followers write no files)."""
    t0 = time.perf_counter()
    if len(parts) < 3:
        raise ValueError("extract needs: extract\\t<videos_dir>\\t<output_npz>")
    feats = _extract_feature_list(extractor_bundle, parts[1], args)
    if leader:
        store_features(parts[2], feats)
    n_frames = sum(len(vf) for vf in feats)
    return (
        f"ok\textracted\t{len(feats)}\t{n_frames}\t{parts[2]}"
        f"\t{time.perf_counter() - t0:.3f}"
    )


def _search_videos(index, aggregation, localizer, extractor, parts, args,
                   leader=True) -> str:
    """``searchv``: raw videos in, candidate (and match) CSVs out; the
    extraction feeds the search core directly."""
    t0 = time.perf_counter()
    if args.ref_fine_features:
        raise ValueError(
            "searchv does not serve the DnS track: DnS queries need "
            "the dns_index re-encoding — run extract, then dns_index, "
            "then the two-file search form"
        )
    if len(parts) < 2:
        raise ValueError(
            "searchv needs: searchv\\t<videos_dir>"
            "[\\t<candidates_csv>[\\t<matches_csv>]]"
        )
    feats = _extract_feature_list(extractor, parts[1], args)
    # Through the npz schema in memory, so video ids and dtypes are the
    # one-shot flow's (CLI npz → Dataset.QUERIES load) exactly.
    buf = io.BytesIO()
    store_features(buf, feats)
    buf.seek(0)
    queries = load_features(buf, Dataset.QUERIES)
    base = parts[1].rstrip("/")
    out_csv = parts[2] if len(parts) > 2 and parts[2] else base + ".candidates.csv"
    matches_csv = parts[3] if len(parts) > 3 and parts[3] else base + ".matches.csv"
    return _respond_search(index, aggregation, localizer, queries, None,
                           out_csv, matches_csv, args, t0, leader)


def _localizer_queries(index, queries, args):
    """A request's query features in the localizer's space: the full
    score-norm transform with the noise-NN bias dimension, plain row L2
    for raw features, or unchanged for DnS (the cg npz is already
    normalized)."""
    if args.ref_fine_features:
        return queries
    if args.score_norm_features:
        return index.localizer_queries(queries)
    return [
        dataclasses.replace(q, feature=l2_normalize_rows(q.feature))
        for q in queries
    ]


def _localizer_refs(index, refs, args):
    """Reference features in the localizer's space (unused in DnS mode,
    whose localizer takes the coarse and fine features as they are)."""
    if args.score_norm_features:
        return index.localizer_ref_features(refs)
    return [
        dataclasses.replace(vf, feature=l2_normalize_rows(vf.feature))
        for vf in refs
    ]


def _add_refs(index, localizer, parts, args, payloads=None) -> str:
    """Serving-time corpus growth: the index and the resident localizer
    tables take the new reference videos. Duplicate ids are rejected.
    The in-band form (``addb``) shares this body with BytesIO sources."""
    t0 = time.perf_counter()
    dns = bool(args.ref_fine_features) and localizer is not None
    if payloads is not None:
        want = 2 if dns else 1
        if len(payloads) != want:
            raise ValueError(
                "addb needs payload lengths: addb\\t<npz_len>"
                + ("\\t<fine_npz_len>" if want == 2 else "")
            )
        sources = [io.BytesIO(b) for b in payloads]
    else:
        if len(parts) < 2:
            raise ValueError("add needs a reference npz: add\\t<refs_npz>")
        sources = parts[1:]
    refs = load_features(sources[0], Dataset.REFS)
    dup = [str(r.video_id) for r in refs if r.video_id in index.video_metadata]
    if dup:
        raise ValueError(f"Reference ids already indexed: {dup[:5]}")
    fine = None
    if dns:
        if len(sources) < 2:
            raise ValueError(
                "DnS add needs two files: add\\t<coarse_npz>\\t<fine_npz>"
            )
        # The fine side loads and cross-checks before anything changes.
        fine = convert_to_dict(load_features(sources[1], Dataset.REFS))
        missing = [str(vf.video_id) for vf in refs if vf.video_id not in fine]
        if missing:
            raise ValueError(f"Fine npz is missing coarse videos: {missing[:5]}")

    def grow_localizer():
        if fine is not None:
            localizer.add_refs(refs, refs_fine=fine)
        else:
            localizer.add_refs(_localizer_refs(index, refs, args))

    # The index validates before it changes anything, so a rejected add
    # leaves the localizer untouched.
    try:
        index.add(refs)
    except Exception:
        if localizer is not None and refs and refs[0].video_id in index.video_metadata:
            # Past validation the index raises only when the device append
            # fails, with its host bookkeeping already grown: grow the
            # localizer too, so both holders agree, and raise the first
            # error.
            try:
                grow_localizer()
            except Exception:
                pass
        raise
    if localizer is not None:
        grow_localizer()
    return f"ok\tadded\t{len(refs)}\t{time.perf_counter() - t0:.3f}"


def _remove_refs(index, localizer, parts) -> str:
    """Serving-time corpus shrink: the index and the resident localizer
    tables drop these videos. Both holders are validated before either
    changes."""
    t0 = time.perf_counter()
    ids = list(dict.fromkeys(p for p in parts[1:] if p))
    if not ids:
        raise ValueError(
            "remove needs video ids: remove\\t<video_id>[\\t<video_id>...]"
        )
    missing = [v for v in ids if v not in index.video_metadata]
    if not missing and localizer is not None:
        missing = [v for v in ids if v not in localizer.refs]
    if missing:
        raise ValueError(f"Video ids not indexed: {missing[:5]}")
    try:
        n_rows = index.remove(ids)
    except Exception:
        # Past validation the index raises only when the device
        # compaction fails, with its host bookkeeping already shrunk:
        # shrink the localizer too before raising.
        if localizer is not None:
            localizer.remove_refs(ids)
        raise
    if localizer is not None:
        localizer.remove_refs(ids)
    return f"ok\tremoved\t{len(ids)}\t{n_rows}\t{time.perf_counter() - t0:.3f}"


def _snapshot(index, localizer, args):
    """The current reference videos (and their fine features in the same
    order, DnS), or a ValueError when the corpus is empty."""
    feats = index.features()
    if not feats:
        raise ValueError(
            "Nothing to save: the served corpus is empty "
            "(every reference video was removed)"
        )
    fine = None
    if args.ref_fine_features:
        fine = [localizer.refs_fine[vf.video_id] for vf in feats]
    return feats, fine


def _save_refs(index, localizer, parts, args, leader=True) -> str:
    """Snapshot the current reference set to npz (the standard schema,
    corpus row order). Pure host work: a failure changes nothing. A
    pod's followers skip the writes."""
    t0 = time.perf_counter()
    if len(parts) < 2:
        raise ValueError("save needs an output path: save\\t<refs_npz>")
    feats, fine = _snapshot(index, localizer, args)
    if fine is not None and len(parts) < 3:
        raise ValueError(
            "DnS save needs two paths: save\\t<coarse_npz>\\t<fine_npz>"
        )
    # Coarse first: a failed fine write leaves a coarse file that loads.
    if leader:
        store_features(parts[1], feats, Dataset.REFS)
        if fine is not None:
            store_features(parts[2], fine, Dataset.REFS)
    tail = f"\t{parts[2]}" if args.ref_fine_features else ""
    return (
        f"ok\tsaved\t{len(feats)}\t{parts[1]}{tail}"
        f"\t{time.perf_counter() - t0:.3f}"
    )


def _save_bytes(index, localizer, args, leader=True):
    """In-band snapshot (``saveb``): the npz bytes (coarse, then fine in
    the DnS mode) go back on the wire. A pod's followers have no client
    to send them to and skip the serialization."""
    t0 = time.perf_counter()
    feats, fine = _snapshot(index, localizer, args)
    if not leader:
        return f"ok\tfollower-save\t{len(feats)}", []
    blobs = []
    for videos in [feats] + ([fine] if fine is not None else []):
        buf = io.BytesIO()
        store_features(buf, videos, Dataset.REFS)
        blobs.append(buf.getvalue())
    header = f"okb\t{len(feats)}\t" + "\t".join(str(len(b)) for b in blobs)
    return header + f"\t{time.perf_counter() - t0:.3f}", blobs


def _search_candidates(index, aggregation, queries, args):
    """Retrieval core of both request forms: budgeted global search,
    then ranked candidate pairs."""
    budget = args.retrieval_per_query * len(queries)
    matches = index.search(queries, global_k=budget)
    candidates = rank_candidates(matches, aggregation)
    return candidates[: args.pairs_per_query * len(queries)]


def _localize_candidates(index, localizer, queries, queries_fine, candidates, args):
    """TN stage: swap the localizer's query side (the reference tables
    stay staged) and align the top candidate pairs."""
    from vsc2022_torch.baseline.pipeline import align_candidates

    if queries_fine is not None:
        localizer.set_queries(queries, queries_fine=queries_fine)
    else:
        localizer.set_queries(_localizer_queries(index, queries, args))
    to_localize = candidates[: int(args.localize_per_query * len(queries))]
    return align_candidates(localizer, to_localize)


def _search_bytes(index, aggregation, localizer, payloads, args):
    """In-band search (``searchb``): query npz bytes in, CSV bytes out."""
    t0 = time.perf_counter()
    want = 2 if args.ref_fine_features else 1
    if payloads is None or len(payloads) != want:
        raise ValueError(
            "searchb needs payload lengths: searchb\\t<npz_len>"
            + ("\\t<fine_npz_len>" if want == 2 else "")
        )
    queries = load_features(io.BytesIO(payloads[0]), Dataset.QUERIES)
    queries_fine = None
    if want == 2:
        queries_fine = convert_to_dict(
            load_features(io.BytesIO(payloads[1]), Dataset.QUERIES)
        )
    candidates = _search_candidates(index, aggregation, queries, args)
    cand_io = io.StringIO()
    CandidatePair.write_csv(candidates, cand_io)
    blobs = [cand_io.getvalue().encode("utf-8")]
    header = f"okb\t{len(candidates)}\t{len(blobs[0])}"
    if localizer is not None:
        found = _localize_candidates(
            index, localizer, queries, queries_fine, candidates, args
        )
        match_io = io.StringIO()
        Match.write_csv(found, match_io)
        blobs.append(match_io.getvalue().encode("utf-8"))
        header += f"\t{len(found)}\t{len(blobs[1])}"
    return header + f"\t{time.perf_counter() - t0:.3f}", blobs


def _respond_search(index, aggregation, localizer, queries, queries_fine,
                    out_csv, matches_csv, args, t0, leader=True) -> str:
    """Candidates (and TN matches) to CSVs. The candidates land on disk
    before the TN stage, so a localization failure still leaves them. A
    pod's followers run the same search and write nothing."""
    candidates = _search_candidates(index, aggregation, queries, args)
    if leader:
        CandidatePair.write_csv(candidates, out_csv)
    if localizer is None:
        return f"ok\t{out_csv}\t{len(candidates)}\t{time.perf_counter() - t0:.3f}"
    found = _localize_candidates(
        index, localizer, queries, queries_fine, candidates, args
    )
    if leader:
        Match.write_csv(found, matches_csv)
    return (
        f"ok\t{out_csv}\t{len(candidates)}\t{matches_csv}\t{len(found)}"
        f"\t{time.perf_counter() - t0:.3f}"
    )


def serve_request(index, aggregation, localizer, line: str, args, payloads=None,
                  extractor=None, leader=True):
    """One request's reply. ``leader`` False: a pod's follower, which runs
    the request alike and writes no file."""
    parts = line.split("\t")
    if parts[0] == "add":
        return _add_refs(index, localizer, parts, args)
    if parts[0] == "remove":
        return _remove_refs(index, localizer, parts)
    if parts[0] == "save":
        return _save_refs(index, localizer, parts, args, leader)
    if parts[0] == "searchb":
        return _search_bytes(index, aggregation, localizer, payloads, args)
    if parts[0] == "addb":
        return _add_refs(index, localizer, parts, args, payloads=payloads)
    if parts[0] == "saveb":
        return _save_bytes(index, localizer, args, leader)
    if parts[0] == "extract":
        return _extract_videos(extractor, parts, args, leader)
    if parts[0] == "searchv":
        return _search_videos(index, aggregation, localizer, extractor, parts, args,
                              leader)
    if parts[0] == "probe":
        raise NotImplementedError("probe is not ported yet")
    if parts[0] == "launches":
        from vsc2022_torch.ops import kernels

        if parts[1:] == ["reset"]:
            kernels.reset_launches()
        return "ok\tlaunches\t" + json.dumps(kernels.launches)
    if parts[0] == "stats":
        return (
            "ok\tstats"
            f"\t{len(index.video_metadata)}"
            f"\t{len(index.video_clip_to_video_ids)}"
            f"\t{index.dtype}"
            f"\t{int(index.mesh is not None)}"
            f"\t{int(args.matches)}"
        )
    query_path = parts[0]
    fine_path = None
    if args.ref_fine_features:
        # The DnS two-file protocol: the second field is the fine npz.
        if len(parts) < 2:
            raise ValueError(
                "DnS serving requests need two query files: "
                "<coarse_npz>\\t<fine_npz>[\\t<candidates_csv>...]"
            )
        fine_path = parts[1]
        parts = [parts[0]] + parts[2:]
    # Empty fields mean "the default", so a client can name the matches
    # CSV without naming the candidates CSV.
    out_csv = parts[1] if len(parts) > 1 and parts[1] else query_path + ".candidates.csv"
    matches_csv = parts[2] if len(parts) > 2 and parts[2] else query_path + ".matches.csv"
    t0 = time.perf_counter()
    queries = load_features(query_path, Dataset.QUERIES)
    queries_fine = None
    if fine_path is not None:
        queries_fine = convert_to_dict(load_features(fine_path, Dataset.QUERIES))
    return _respond_search(
        index, aggregation, localizer, queries, queries_fine,
        out_csv, matches_csv, args, t0, leader,
    )


def _warm_up(index, localizer, refs, dim, args) -> None:
    """Stage the corpus and load the kernels with one search (and one
    alignment) before 'ready'. Random unit queries, not zeros: a zero
    query scores every row exactly τ = 0, the count-verify's worst case."""
    rng = np.random.RandomState(0)
    f = rng.standard_normal((8, dim)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    warm = VideoFeature(
        video_id="Q999999", timestamps=np.arange(8, dtype=np.float64), feature=f
    )
    index.search([warm], global_k=8)
    if localizer is None or not refs:
        return
    if args.ref_fine_features:
        fine_dim = next(iter(localizer.refs_fine.values())).dimensions()
        warm_fine = VideoFeature(
            video_id=warm.video_id, timestamps=warm.timestamps,
            feature=rng.standard_normal((8, fine_dim)).astype(np.float32),
        )
        localizer.set_queries([warm], queries_fine={warm.video_id: warm_fine})
    else:
        localizer.set_queries(_localizer_queries(index, [warm], args))
    localizer.localize_all([CandidatePair(warm.video_id, refs[0].video_id, 1.0)])


def main(args):
    multihost = check_multihost(args)
    if multihost:
        from vsc2022_torch.parallel.mesh import initialize_distributed

        logger.info("Joining serving pod as rank %d of %d (coordinator: %s)",
                    args.process_id, args.num_processes, args.coordinator)
        rank_dev = initialize_distributed(args.coordinator, args.num_processes,
                                          args.process_id, backend=args.dist_backend,
                                          device=args.device)
    if args.ref_fine_features:
        if args.score_norm_features:
            # dns_index applies score normalization (reference:
            # vsc/baseline/dns_index.py:143-161); the coarse npz arrives
            # normalized.
            raise ValueError(
                "DnS serving expects the score-normalized coarse npz "
                "from dns_index; --score_norm_features does not apply."
            )
        args.matches = True
    device = rank_dev if multihost else resolve_device(args.device)
    t0 = time.perf_counter()
    # The extractor first: its flag checks (--baseline without weights)
    # fail before the corpus stages.
    extractor = build_extractor(args, device)
    index, refs, dim = build_index(args, device)
    localizer = build_localizer(index, refs, args, device) if args.matches else None
    if not args.no_warmup:
        _warm_up(index, localizer, refs, dim, args)
    stage_s = time.perf_counter() - t0
    aggregation = MaxScoreAggregation()
    if multihost and args.process_id != 0:
        # A follower: no client protocol; it runs the leader's relayed
        # requests in lockstep until the leader releases the pod.
        print(f"follower\t{args.process_id}\t{stage_s:.1f}", flush=True)
        _follow(index, aggregation, localizer, args, extractor=extractor)
        logger.info("Follower rank released by the leader; exiting")
        return
    relay = _Relay(args) if multihost else None
    try:
        print(f"ready\t{len(refs)}\t{stage_s:.1f}", flush=True)
        logger.info(f"Serving {len(refs)} reference videos on {device} "
                    f"(staged in {stage_s:.1f}s)")
        if args.listen:
            _serve_tcp(index, aggregation, localizer, args, stage_s, extractor=extractor,
                       relay=relay)
        else:
            _serve_stream(index, aggregation, localizer, args, sys.stdin.buffer,
                          sys.stdout.buffer, extractor=extractor, relay=relay)
    finally:
        if relay is not None:
            relay.close()


def _read_payloads(rfile, head):
    """Read the payload bytes an in-band command announces in its header
    (``<cmd>\\t<len1>[\\t<len2>...]``). Raises on malformed lengths before
    reading any payload, and on short reads (EOFError)."""
    try:
        sizes = [int(n) for n in head[1:]]
    except ValueError:
        raise ValueError(f"{head[0]} needs integer payload lengths, got {head[1:]}")
    if not sizes or any(n < 0 for n in sizes):
        raise ValueError(f"{head[0]} needs positive payload lengths")
    payloads = []
    for n in sizes:
        blob = rfile.read(n)
        if len(blob) != n:
            raise EOFError(f"short payload: expected {n} bytes, got {len(blob)}")
        payloads.append(blob)
    return payloads


class _Relay:
    """The leader's fan-out of every request to the follower ranks, in
    execution order (``forward`` runs under the device lock): the ranks
    must run the same collectives, and the leader alone in one would hang
    the pod. ``close`` releases the followers (idempotent; main's
    ``finally`` calls it on every exit path)."""

    def __init__(self, args):
        import socket

        host, port = args.control.rsplit(":", 1)
        srv = socket.create_server((host, int(port)))
        # Staging is collective, so live followers connect when the leader
        # gets here; a rank minutes late is dead, and waiting on it forever
        # would wedge the pod.
        srv.settimeout(180.0)
        self._conns = []
        logger.info("Waiting for %d follower rank(s) on %s", args.num_processes - 1,
                    args.control)
        try:
            for _ in range(args.num_processes - 1):
                conn, addr = srv.accept()
                self._conns.append(conn)
                logger.info("Follower attached from %s:%d", *addr[:2])
        finally:
            srv.close()
        self._closed = False

    def forward(self, raw: bytes, payloads) -> None:
        """Relay one request to every follower, failing fast if a rank
        died: a collective on a broken pod would hang the leader, so a dead
        follower turns requests into error responses. Followers never
        write on the control socket, so readability (EOF) is the liveness
        check; a rank that dies after its relay is left to the process
        group's own failure."""
        import select

        if self._closed:
            raise RuntimeError("The pod is degraded (a follower rank died); "
                               "restart every rank")
        readable, _, _ = select.select(self._conns, [], [], 0)
        if readable:
            self.close()
            raise RuntimeError("A follower rank died (control channel EOF); the pod "
                               "mesh is broken: restart every rank")
        try:
            for conn in self._conns:
                conn.sendall(raw)
                for blob in payloads or ():
                    conn.sendall(blob)
        except OSError as exc:
            self.close()
            raise RuntimeError(f"Relaying to a follower rank failed ({exc}); the pod "
                               "mesh is broken: restart every rank")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.sendall(b"shutdown\n")
                conn.close()
            except OSError:
                pass


def _follow(index, aggregation, localizer, args, extractor=None) -> None:
    """A follower's request loop: run every request the leader relays
    (the same bytes, in the same order), so the ranks' collectives stay
    in lockstep. Files are the leader's; a request error is the same on
    every rank (the same inputs), so it leaves every rank alike."""
    import socket

    host, port = args.control.rsplit(":", 1)
    deadline = time.monotonic() + 120
    while True:
        try:
            sock = socket.create_connection((host, int(port)))
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    logger.info("Follower rank connected to the leader's control channel")
    with sock:
        rfile = sock.makefile("rb")
        while True:
            raw = rfile.readline()
            if not raw:
                return
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            if line == "shutdown":
                return
            head = line.split("\t")
            try:
                payloads = (_read_payloads(rfile, head)
                            if head[0] in ("searchb", "addb") else None)
                response = serve_request(index, aggregation, localizer, line, args,
                                         payloads=payloads, extractor=extractor,
                                         leader=False)
                if isinstance(response, tuple):
                    response = response[0]
                logger.info("Follower reply: %s", response)
            except EOFError:
                return
            except Exception as exc:
                logger.info("Follower request error: %s", exc)


def _serve_stream(index, aggregation, localizer, args, rfile, wfile,
                  lock=None, extractor=None, relay=None) -> bool:
    """Answer one binary request stream until quit/shutdown/EOF; returns
    True when the whole server should stop. ``lock`` serializes device
    and localizer state across TCP client threads; ``relay`` (a pod's
    leader) forwards each request to the followers first, under it."""
    while True:
        raw = rfile.readline()
        if not raw:
            return False
        line = raw.decode("utf-8", errors="replace").strip()
        if not line:
            continue
        if line == "quit":
            return False
        if line == "shutdown":
            return True
        head = line.split("\t")
        blobs = None
        try:
            payloads = (
                _read_payloads(rfile, head) if head[0] in ("searchb", "addb") else None
            )
            with lock if lock is not None else contextlib.nullcontext():
                if relay is not None:
                    relay.forward(raw, payloads)
                response = serve_request(
                    index, aggregation, localizer, line, args, payloads=payloads,
                    extractor=extractor,
                )
            if isinstance(response, tuple):
                response, blobs = response
        except EOFError:
            return False  # the client died mid-payload
        except Exception as exc:  # keep serving on request errors
            response = "error\t" + str(exc).replace("\n", " ")
        wfile.write((response + "\n").encode("utf-8"))
        for blob in blobs or ():
            wfile.write(blob)
        wfile.flush()


def _serve_tcp(index, aggregation, localizer, args, stage_s: float,
               extractor=None, relay=None) -> None:
    """TCP accept loop speaking the stdin protocol, one thread per client,
    requests serialized on one device lock."""
    import socket
    import threading

    host, port = args.listen.rsplit(":", 1)
    srv = socket.create_server((host, int(port)))
    bound = srv.getsockname()[1]
    print(f"listening\t{host}:{bound}", flush=True)
    logger.info(f"Listening on {host}:{bound}")
    device_lock = threading.Lock()
    stop = threading.Event()

    def client_session(conn, addr):
        try:
            with conn:
                rfile = conn.makefile("rb")
                wfile = conn.makefile("wb")
                # The greeting's count is read live: adds and removes
                # change it during the server's life.
                with device_lock:
                    ready = f"ready\t{len(index.video_metadata)}\t{stage_s:.1f}"
                wfile.write((ready + "\n").encode("utf-8"))
                wfile.flush()
                if _serve_stream(index, aggregation, localizer, args, rfile,
                                 wfile, lock=device_lock, extractor=extractor,
                                 relay=relay):
                    stop.set()
        except (BrokenPipeError, ConnectionResetError):
            logger.info(f"Client {addr[0]}:{addr[1]} disconnected")

    # A 1 s accept timeout polls the stop flag.
    srv.settimeout(1.0)
    threads = []
    while not stop.is_set():
        try:
            conn, addr = srv.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        logger.info(f"Client connected: {addr[0]}:{addr[1]}")
        t = threading.Thread(target=client_session, args=(conn, addr), daemon=True)
        t.start()
        threads.append(t)
    srv.close()
    for t in threads:  # in-flight requests finish; new connections refused
        t.join(timeout=60)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
        stream=sys.stderr,
    )
    main(parser.parse_args())
