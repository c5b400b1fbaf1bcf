"""Python client for the port's resident retrieval server.

The server (``python -m vsc2022_torch.retrieval.serve``) speaks a line
protocol over stdin/stdout or TCP; this client turns it into calls with
typed results. It is the port's own copy of the JAX package's client
(``vsc2022_tpu/retrieval/client.py``), which cannot be imported without
JAX. Two ways in:

    # The server as a child process (stdio):
    with ServeClient.spawn("refs.npz", score_norm_features="noise.npz",
                           matches=True, device="cpu") as client:
        result = client.search("queries.npz")
        pairs = result.candidates()          # List[CandidatePair]
        client.add("more_refs.npz")
        found = client.search_features(queries)  # in-band: no shared paths

    # Or attach to a running --listen server:
    with ServeClient.connect("127.0.0.1", 7845) as client:
        ...

The typed API is the JAX client's (``search`` / ``SearchResult.candidates``
and ``.matches``, the in-band ``search_features``, ``add_features`` and
``snapshot``, ``add`` / ``remove`` / ``save`` / ``stats``, and with a
resident model ``extract`` / ``search_videos``); ``search_bytes``
(CSV bytes as they come) and ``launches`` (the kernel launch counts) are
the port's own. One request at a time per client: the protocol is strictly
request and response. Concurrent callers open one connection each to a
``--listen`` server, whose sessions interleave under its device lock.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

from vsc2022_torch.metrics import CandidatePair, Dataset, Match
from vsc2022_torch.storage import load_features, store_features
from vsc2022_torch.utils.procs import die_with_parent


class ServeError(RuntimeError):
    """A request the server answered with ``error\\t<message>``."""


@dataclasses.dataclass
class SearchResult:
    """One answered path search (where the CSVs are, counts, seconds)."""

    candidates_csv: str
    n_candidates: int
    matches_csv: Optional[str]
    n_matches: Optional[int]
    seconds: float

    def candidates(self) -> List[CandidatePair]:
        return CandidatePair.read_csv(self.candidates_csv)

    def matches(self) -> List[Match]:
        if self.matches_csv is None:
            raise ValueError("server ran without --matches: no matches CSV to read")
        return Match.read_csv(self.matches_csv)


@dataclasses.dataclass
class InbandSearchResult:
    """One answered in-band search (``search_features``): the parsed
    result objects, no filesystem on either side."""

    candidates: List[CandidatePair]
    matches: Optional[List[Match]]
    seconds: float


@dataclasses.dataclass
class BytesSearchResult:
    """One answered in-band search: the CSV bytes themselves."""

    candidates_csv: bytes
    n_candidates: int
    matches_csv: Optional[bytes]
    n_matches: Optional[int]
    seconds: float


@dataclasses.dataclass
class ServeStats:
    """Live server state (the ``stats`` command)."""

    n_videos: int
    n_frames: int
    dtype: str
    sharded: bool
    matches: bool


class ServeClient:
    """Session against one resident server; not thread-safe."""

    def __init__(self, rfile, wfile, proc=None, sock=None):
        self._rfile = rfile
        self._wfile = wfile
        self._proc = proc
        self._sock = sock
        self.n_ref_videos, self.stage_seconds = self._read_ready()

    # -- constructors ------------------------------------------------

    @classmethod
    def spawn(
        cls,
        ref_features: str,
        *,
        score_norm_features: Optional[str] = None,
        ref_fine_features: Optional[str] = None,
        matches: bool = False,
        sharded: bool = False,
        bf16: bool = False,
        f32: bool = False,
        int8: bool = False,
        vcsl_faithful_tn: bool = False,
        no_warmup: bool = False,
        device: str = "cuda",
        extra_args: Sequence[str] = (),
        env=None,
        cwd=None,
        stderr=None,
    ) -> "ServeClient":
        """Start ``python -m vsc2022_torch.retrieval.serve`` as a child
        process and attach over its stdin/stdout. Keyword flags mirror the
        server's (with none of ``bf16``, ``f32`` and ``int8`` it stages
        bf16, its default); anything else goes through ``extra_args``.
        The child ends with the client (``close`` sends ``quit``) and is
        killed if the calling process dies."""
        cmd = [
            sys.executable, "-m", "vsc2022_torch.retrieval.serve",
            "--ref_features", os.path.abspath(ref_features),
            "--device", device,
        ]
        if score_norm_features:
            cmd += ["--score_norm_features", os.path.abspath(score_norm_features)]
        if ref_fine_features:
            cmd += ["--ref_fine_features", os.path.abspath(ref_fine_features)]
        for flag, on in (("--matches", matches), ("--sharded", sharded),
                         ("--bf16", bf16), ("--f32", f32),
                         ("--int8", int8),
                         ("--vcsl_faithful_tn", vcsl_faithful_tn),
                         ("--no_warmup", no_warmup)):
            if on:
                cmd.append(flag)
        cmd += list(extra_args)
        proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr, env=env, cwd=cwd, preexec_fn=die_with_parent,
        )
        try:
            return cls(proc.stdout, proc.stdin, proc=proc)
        except BaseException:
            proc.kill()
            proc.wait()
            raise

    @classmethod
    def connect(cls, host: str, port: int, timeout: Optional[float] = None
                ) -> "ServeClient":
        """Attach to a running ``--listen HOST:PORT`` server. ``timeout``
        bounds the connection only; replies block as long as they take."""
        import socket

        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            sock.settimeout(None)
            return cls(sock.makefile("rb"), sock.makefile("wb"), sock=sock)
        except BaseException:
            sock.close()
            raise

    # -- protocol ----------------------------------------------------

    def _read_line(self) -> str:
        return self._rfile.readline().decode("utf-8", "replace").strip()

    def _read_ready(self):
        line = self._read_line()
        parts = line.split("\t")
        if parts[0] != "ready":
            detail = f"expected ready line, got: {line!r}"
            if self._proc is not None and not line:
                try:
                    code = self._proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    code = None
                detail += f" (server exited with code {code} during startup)"
            raise ServeError(detail)
        return int(parts[1]), float(parts[2])

    def _rpc(self, line: str, blobs: Sequence[bytes] = ()) -> List[str]:
        self._write_line(line)
        for blob in blobs:
            self._wfile.write(blob)
        self._wfile.flush()
        reply = self._read_line()
        if not reply:
            raise ServeError("server closed the connection")
        parts = reply.split("\t")
        if parts[0] == "error":
            raise ServeError("\t".join(parts[1:]))
        if parts[0] not in ("ok", "okb"):
            raise ServeError(f"malformed server reply: {reply!r}")
        return parts[1:]

    def _read_blob(self, n: int) -> bytes:
        blob = self._rfile.read(n)
        if len(blob) != n:
            raise ServeError(f"short server payload: {len(blob)} of {n} bytes")
        return blob

    def _write_line(self, line: str) -> None:
        self._wfile.write((line + "\n").encode("utf-8"))

    @staticmethod
    def _npz_bytes(features, dataset: Dataset) -> bytes:
        """npz bytes of a list of VideoFeature or a {video_id: feature} dict."""
        if isinstance(features, dict):
            features = features.values()
        buf = io.BytesIO()
        store_features(buf, list(features), dataset)
        return buf.getvalue()

    # -- requests ----------------------------------------------------

    def search(
        self,
        query_features: str,
        *,
        query_fine_features: Optional[str] = None,
        candidates_csv: Optional[str] = None,
        matches_csv: Optional[str] = None,
    ) -> SearchResult:
        """Search one query npz; returns where the server wrote the CSVs
        (defaults: ``<query_npz>.candidates.csv`` / ``.matches.csv``).
        DnS servers need ``query_fine_features`` too. Paths are made
        absolute here: the server may run in another directory."""
        fields = [os.path.abspath(query_features)]
        if query_fine_features is not None:
            fields.append(os.path.abspath(query_fine_features))
        if candidates_csv is not None or matches_csv is not None:
            fields.append(os.path.abspath(candidates_csv) if candidates_csv else "")
        if matches_csv is not None:
            fields.append(os.path.abspath(matches_csv))
        return self._search_reply(self._rpc("\t".join(fields)))

    @staticmethod
    def _search_reply(parts: List[str]) -> SearchResult:
        if len(parts) >= 5:
            return SearchResult(parts[0], int(parts[1]), parts[2], int(parts[3]),
                                float(parts[4]))
        return SearchResult(parts[0], int(parts[1]), None, None, float(parts[2]))

    def search_bytes(self, query_npz: bytes, fine_npz: Optional[bytes] = None
                     ) -> BytesSearchResult:
        """In-band search (``searchb``): the query npz bytes travel on the
        wire and the CSV bytes come back the same way."""
        blobs = [query_npz] + ([fine_npz] if fine_npz is not None else [])
        parts = self._rpc("\t".join(["searchb"] + [str(len(b)) for b in blobs]),
                          blobs=blobs)
        # okb\t<n_cand>\t<cand_len>[\t<n_matches>\t<match_len>]\t<s>
        cand = self._read_blob(int(parts[1]))
        if len(parts) >= 5:
            found = self._read_blob(int(parts[3]))
            return BytesSearchResult(cand, int(parts[0]), found, int(parts[2]),
                                     float(parts[4]))
        return BytesSearchResult(cand, int(parts[0]), None, None, float(parts[2]))

    def search_features(self, queries, *, queries_fine=None) -> InbandSearchResult:
        """Search a list of VideoFeature directly: the query npz bytes go
        on the wire (``searchb``) and the CSVs come back the same way,
        parsed. DnS servers need ``queries_fine`` (list or dict)."""
        fine = None if queries_fine is None else self._npz_bytes(
            queries_fine, Dataset.QUERIES)
        res = self.search_bytes(self._npz_bytes(queries, Dataset.QUERIES), fine)
        return InbandSearchResult(
            candidates=CandidatePair.read_csv(io.StringIO(res.candidates_csv.decode())),
            matches=None if res.matches_csv is None
            else Match.read_csv(io.StringIO(res.matches_csv.decode())),
            seconds=res.seconds,
        )

    def add_features(self, refs, refs_fine=None) -> int:
        """Grow the served corpus from VideoFeature lists directly (``addb``:
        the npz bytes go on the wire); returns the number of videos added.
        DnS servers need the matching fine features (list or dict)."""
        blobs = [self._npz_bytes(refs, Dataset.REFS)]
        if refs_fine is not None:
            blobs.append(self._npz_bytes(refs_fine, Dataset.REFS))
        parts = self._rpc("\t".join(["addb"] + [str(len(b)) for b in blobs]),
                          blobs=blobs)
        if parts[0] != "added":
            raise ServeError(f"unexpected addb reply: {parts!r}")
        return int(parts[1])

    def snapshot(self):
        """The served corpus (after any adds and removes) as VideoFeature
        lists (``saveb``: the npz bytes come back on the wire): (refs, fine
        refs or None)."""
        parts = self._rpc("saveb")
        # okb\t<n_videos>\t<coarse_len>[\t<fine_len>]\t<seconds>
        refs = load_features(io.BytesIO(self._read_blob(int(parts[1]))), Dataset.REFS)
        fine = None
        if len(parts) >= 4:
            fine = load_features(io.BytesIO(self._read_blob(int(parts[2]))),
                                 Dataset.REFS)
        return refs, fine

    def add(self, ref_features: str, ref_fine_features: Optional[str] = None) -> int:
        """Grow the served corpus; returns the number of videos added. DnS
        servers need the matching fine npz too."""
        fields = ["add", os.path.abspath(ref_features)]
        if ref_fine_features is not None:
            fields.append(os.path.abspath(ref_fine_features))
        parts = self._rpc("\t".join(fields))
        if parts[0] != "added":
            raise ServeError(f"unexpected add reply: {parts!r}")
        return int(parts[1])

    def remove(self, video_ids: Sequence[str]) -> Tuple[int, int]:
        """Drop reference videos; returns (videos, frame rows) removed."""
        ids = [str(v) for v in video_ids]
        if not ids:
            raise ValueError("remove needs at least one video id")
        parts = self._rpc("\t".join(["remove"] + ids))
        if parts[0] != "removed":
            raise ServeError(f"unexpected remove reply: {parts!r}")
        return int(parts[1]), int(parts[2])

    def save(self, ref_features: str, ref_fine_features: Optional[str] = None) -> int:
        """Snapshot the served corpus to npz; returns the number of videos
        saved. DnS servers need a second path for the fine features."""
        fields = ["save", os.path.abspath(ref_features)]
        if ref_fine_features is not None:
            fields.append(os.path.abspath(ref_fine_features))
        parts = self._rpc("\t".join(fields))
        if parts[0] != "saved":
            raise ServeError(f"unexpected save reply: {parts!r}")
        return int(parts[1])

    # -- end-to-end requests (a server started with --baseline and weights) --

    def extract(self, videos_dir: str, output_npz: str) -> Tuple[int, int]:
        """Decode and embed a video directory on the server's resident
        model, writing a descriptor npz; returns (n_videos, n_frames)."""
        parts = self._rpc(f"extract\t{os.path.abspath(videos_dir)}"
                          f"\t{os.path.abspath(output_npz)}")
        if parts[0] != "extracted":
            raise ServeError(f"unexpected extract reply: {parts!r}")
        return int(parts[1]), int(parts[2])

    def search_videos(
        self,
        videos_dir: str,
        *,
        candidates_csv: Optional[str] = None,
        matches_csv: Optional[str] = None,
    ) -> SearchResult:
        """Raw videos in, candidate (and match) CSVs out: the server embeds
        the directory on its resident model and searches in one request
        (defaults: ``<videos_dir>.candidates.csv`` / ``.matches.csv``)."""
        fields = ["searchv", os.path.abspath(videos_dir)]
        if candidates_csv is not None or matches_csv is not None:
            fields.append(os.path.abspath(candidates_csv) if candidates_csv else "")
        if matches_csv is not None:
            fields.append(os.path.abspath(matches_csv))
        return self._search_reply(self._rpc("\t".join(fields)))

    def stats(self) -> ServeStats:
        parts = self._rpc("stats")
        if parts[0] != "stats":
            raise ServeError(f"unexpected stats reply: {parts!r}")
        return ServeStats(int(parts[1]), int(parts[2]), parts[3],
                          bool(int(parts[4])), bool(int(parts[5])))

    def launches(self, reset: bool = False) -> dict:
        """The server process's kernel launch counts ({kernel: count});
        ``reset`` zeroes them first."""
        parts = self._rpc("launches\treset" if reset else "launches")
        if parts[0] != "launches":
            raise ServeError(f"unexpected launches reply: {parts!r}")
        return json.loads(parts[1])

    # -- lifecycle ---------------------------------------------------

    def close(self, shutdown: bool = False) -> None:
        """End the session (``quit``); ``shutdown=True`` stops a TCP
        server. A spawned child is reaped (killed after 30 s if wedged)."""
        try:
            self._wfile.write(b"shutdown\n" if shutdown else b"quit\n")
            self._wfile.flush()
        except (BrokenPipeError, ValueError, OSError):
            pass  # already gone
        if self._sock is not None:
            self._rfile.close()
            self._wfile.close()
            self._sock.close()
        if self._proc is not None:
            try:
                self._proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
