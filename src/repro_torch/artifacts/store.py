"""ArtifactStore: persistent program artifacts, zero-synthesis warm starts.

The counterpart of ``repro.artifacts.store``, with the reference's layout:

  programs/<fingerprint>/      one complete program artifact
    manifest.json              schema version, producer and content digests
                               (written LAST: a directory without a valid
                               manifest is an unfinished write)
    program.json               plan + graph + modes + audit reports (codec)
    weights.json, weights.bin  Stage B's prepared weights, raw bytes
  index/<request_key>.json     synthesis-request key -> fingerprint, so that
                               ``synthesize(artifact_store=...)`` finds the
                               converged artifact before running the loop
                               that would compute its fingerprint

Identity and integrity rules (DESIGN.md §13), as in the reference:

* The artifact key is the converged program fingerprint (plan dispatch
  content, graph fusion digest, :meth:`DeviceProfile.identity`, prepared
  weights digest).
* Every file is written atomically (temp file in the same directory +
  ``os.replace``), so racing writers leave one winner and readers never see
  partial content.
* A loaded program is self-validated: every file's sha256 must match the
  manifest, and its fingerprint is recomputed from the decoded plan and
  weights and compared with the directory's name and the manifest's claim.
  A mismatch or an unknown ``schema_version`` rejects the artifact, counts
  ``artifact_invalid_total`` and reads as a miss.
* The manifest and the index entries name their producer (``repro_torch``).
  A directory the JAX package wrote is foreign: a miss, not invalid, and
  never hydrated.

Stage-D executables: the port writes none (``codec.executables_supported()``
is ``False``; a CUDA graph is not serializable), so every bucket a
:class:`~repro_torch.serving.ProgramCache` asks for is a ``kind=executable``
miss and one Stage-D build: the reference's plan-only fallback.

Observability: ``artifact_{hits,misses,writes,invalid}_total`` and
``artifact_hydrate_seconds_total`` counters (labeled
``kind=program|executable``) and ``serve.artifact_hydrate`` spans, in the
registry and tracer the constructor is handed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import TYPE_CHECKING, Any, Dict, Optional

import torch

from ..core.precision import QuantizedTensor
from ..obs import MetricsRegistry, Tracer
from . import codec
from .codec import PRODUCER, ArtifactCodecError

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.network import NetworkDescription
    from ..core.planner import PlannerConfig
    from ..core.synthesizer import BatchProgram, SynthesizedProgram

#: Version tag of the on-disk layout; bump on any incompatible change.
ARTIFACT_SCHEMA_VERSION = 1

_PROGRAM_FILES = ("program.json", "weights.json", "weights.bin")


class ArtifactError(ValueError):
    """An artifact is missing, malformed, or fails integrity checks."""


class _Foreign(Exception):
    """An artifact another producer wrote: a miss, never hydrated."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    """Temp file in the target directory + rename: readers see the old
    content or the new, never a torn write; racing writers leave one
    winner (the last rename)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _json_bytes(doc: Any) -> bytes:
    return (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()


def _read_json(path: str) -> Any:
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactError(f"{path}: not valid JSON ({e})") from None


def _check_header(doc: Any, path: str) -> None:
    """Schema version (invalid when unknown), then producer (foreign when
    another package wrote it)."""
    if not isinstance(doc, dict):
        raise ArtifactError(f"{path}: must be a JSON object")
    if doc.get("schema_version") != ARTIFACT_SCHEMA_VERSION:
        raise ArtifactError(
            f"{path}: unknown artifact schema_version "
            f"{doc.get('schema_version')!r} (this build reads "
            f"{ARTIFACT_SCHEMA_VERSION}); refusing to guess")
    if doc.get("producer") != PRODUCER:
        raise _Foreign(f"{path}: written by {doc.get('producer')!r}, "
                       f"not {PRODUCER!r}")


# ---------------------------------------------------------------------------
# Synthesis-request keys: the converged fingerprint is an output of
# synthesis, so a request is keyed by its inputs.
# ---------------------------------------------------------------------------

def _hash_tensors(h: "hashlib._Hash", tree: Any) -> None:
    """Tensors (nested in dicts, lists and tuples) by dtype, shape and
    little-endian bytes after a copy to the host."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            h.update(f"<{k}>".encode())
            _hash_tensors(h, tree[k])
    elif isinstance(tree, (list, tuple)):
        h.update(f"[{len(tree)}]".encode())
        for leaf in tree:
            _hash_tensors(h, leaf)
    elif isinstance(tree, QuantizedTensor):
        _hash_tensors(h, {"q": tree.q, "scale": tree.scale})
    else:
        t = torch.as_tensor(tree)
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(codec.tensor_bytes(t))


def _planner_config_key(config: "Optional[PlannerConfig]") -> str:
    """Every :class:`PlannerConfig` field but the profile (whose identity is
    hashed on its own), and whether rule 3 may route to the kernels on this
    machine (``allow_pallas=None`` resolves against CUDA)."""
    if config is None:
        from ..core.planner import PlannerConfig
        config = PlannerConfig()
    fields = {f.name: getattr(config, f.name)
              for f in dataclasses.fields(config) if f.name != "profile"}
    fields["pallas_enabled"] = config.pallas_enabled
    return json.dumps(fields, sort_keys=True, default=repr)


def synthesis_request_key(net: "NetworkDescription", params: Any, *,
                          validation: Any = None,
                          device_identity: str = "",
                          max_degradation: float = 0.0,
                          allow_int8: bool = False,
                          forced_mode: Any = None,
                          fuse: bool = True,
                          autotune: bool = False,
                          max_iterations: int = 0,
                          planner_config: "Optional[PlannerConfig]" = None,
                          autotune_input: Optional[torch.Tensor] = None
                          ) -> str:
    """Digest of everything that determines what ``synthesize`` returns.

    What the reference's key covers (the network, the raw parameters, the
    validation set, the device identity, the loop's knobs) plus every
    :class:`PlannerConfig` field and a digest of ``autotune_input``.  The
    reference's key leaves those two out, so there a request for
    ``PlannerConfig(batch=1)`` can hydrate the program synthesized for
    ``batch=8``; here it misses.
    """
    h = hashlib.sha256()
    h.update(json.dumps(codec.encode_network(net), sort_keys=True).encode())
    h.update(f"|device={device_identity}".encode())
    h.update(f"|deg={max_degradation!r}|int8={allow_int8}"
             f"|forced={getattr(forced_mode, 'value', None)!r}"
             f"|fuse={fuse}|autotune={autotune}"
             f"|iters={max_iterations}".encode())
    h.update(f"|planner={_planner_config_key(planner_config)}".encode())
    h.update(b"|params:")
    _hash_tensors(h, params)
    for label, value in (("validation", validation),
                         ("autotune_input", autotune_input)):
        h.update(f"|{label}:".encode())
        if value is None:
            h.update(b"none")
        else:
            _hash_tensors(h, list(value) if label == "validation" else value)
    return h.hexdigest()[:24]


class ArtifactStore:
    """Versioned, integrity-checked on-disk store of synthesis artifacts.

    Process- and thread-safe through filesystem atomicity: every write is
    temp + rename, every read validates again.  Failed integrity checks are
    misses, not errors; the only exceptions that escape are programmer
    errors and unwritable roots.
    """

    def __init__(self, root: str, *,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.root = str(root)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        os.makedirs(os.path.join(self.root, "programs"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "index"), exist_ok=True)
        reg = self.registry
        self._hits = reg.counter(
            "artifact_hits_total",
            "Artifact-store loads that hydrated successfully", ("kind",))
        self._misses = reg.counter(
            "artifact_misses_total",
            "Artifact-store lookups that found nothing usable", ("kind",))
        self._writes = reg.counter(
            "artifact_writes_total",
            "Artifacts persisted to the store", ("kind",))
        self._invalid = reg.counter(
            "artifact_invalid_total",
            "Artifacts rejected: tampered, truncated, or wrong schema "
            "version", ("kind",))
        self._hydrate_seconds = reg.counter(
            "artifact_hydrate_seconds_total",
            "Wall seconds spent hydrating artifacts from disk", ("kind",))
        for c in (self._hits, self._misses, self._writes, self._invalid,
                  self._hydrate_seconds):
            for kind in ("program", "executable"):
                c.inc(0, kind=kind)              # materialize zero series

    # -- paths ---------------------------------------------------------------
    def program_dir(self, fingerprint: str) -> str:
        if not fingerprint or "/" in fingerprint or fingerprint.startswith("."):
            raise ValueError(f"bad fingerprint {fingerprint!r}")
        return os.path.join(self.root, "programs", fingerprint)

    def _index_path(self, request_key: str) -> str:
        if not request_key or "/" in request_key or request_key.startswith("."):
            raise ValueError(f"bad request key {request_key!r}")
        return os.path.join(self.root, "index", f"{request_key}.json")

    # -- counter reads (labels summed) ---------------------------------------
    def _sum(self, counter) -> int:
        return int(sum(counter.series().values()))

    @property
    def hits(self) -> int:
        return self._sum(self._hits)

    @property
    def misses(self) -> int:
        return self._sum(self._misses)

    @property
    def writes(self) -> int:
        return self._sum(self._writes)

    @property
    def invalid(self) -> int:
        return self._sum(self._invalid)

    def stats(self) -> Dict[str, int]:
        out = {}
        for name, counter in (("hits", self._hits), ("misses", self._misses),
                              ("writes", self._writes),
                              ("invalid", self._invalid)):
            for key, value in counter.series().items():
                out[f"{name}_{key[0]}"] = int(value)
            out[name] = self._sum(counter)
        return out

    def _event(self, name: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.event(name, **attrs)

    # -- index: request key -> fingerprint -----------------------------------
    def lookup(self, request_key: str) -> Optional[str]:
        """The converged fingerprint an earlier identical request produced,
        or None.  A malformed or version-bumped entry counts invalid; one
        another producer wrote is ignored; both read as None."""
        path = self._index_path(request_key)
        if not os.path.exists(path):
            return None
        try:
            doc = _read_json(path)
            _check_header(doc, path)
            fp = doc.get("fingerprint")
            if not isinstance(fp, str) or not fp:
                raise ArtifactError("index entry carries no fingerprint")
            return fp
        except _Foreign:
            return None
        except ArtifactError:
            self._invalid.inc(kind="program")
            return None

    def _write_index(self, request_key: str, fingerprint: str) -> None:
        _atomic_write(self._index_path(request_key), _json_bytes({
            "schema_version": ARTIFACT_SCHEMA_VERSION, "producer": PRODUCER,
            "fingerprint": fingerprint}))

    # -- programs (Stages A-C + Stage B weights) -----------------------------
    def put_program(self, program: "SynthesizedProgram", *,
                    request_key: Optional[str] = None) -> str:
        """Persist a synthesized program; returns its fingerprint.

        Files land one by one (each atomic), the manifest last; with
        ``request_key`` the index entry is written after the artifact, so
        an index hit always points at something.
        """
        fp = program.fingerprint()
        d = self.program_dir(fp)
        os.makedirs(d, exist_ok=True)
        program_raw = _json_bytes(codec.encode_program(program))
        entries, weights_blob = codec.encode_weights(program.prepared)
        weights_doc_raw = (json.dumps(entries, sort_keys=True) + "\n").encode()

        _atomic_write(os.path.join(d, "program.json"), program_raw)
        _atomic_write(os.path.join(d, "weights.json"), weights_doc_raw)
        _atomic_write(os.path.join(d, "weights.bin"), weights_blob)
        _atomic_write(os.path.join(d, "manifest.json"), _json_bytes({
            "schema_version": ARTIFACT_SCHEMA_VERSION,
            "producer": PRODUCER,
            "fingerprint": fp,
            "net": program.net.name,
            "files": {"program.json": _sha256(program_raw),
                      "weights.json": _sha256(weights_doc_raw),
                      "weights.bin": _sha256(weights_blob)},
        }))
        if request_key is not None:
            self._write_index(request_key, fp)
        self._writes.inc(kind="program")
        return fp

    def load_program(self, fingerprint: str, *,
                     device: "str | torch.device" = "cuda"
                     ) -> "Optional[SynthesizedProgram]":
        """Hydrate Stages A–C from disk with the prepared weights on
        ``device``, or None (counted hit, miss or invalid)."""
        d = self.program_dir(fingerprint)
        t0 = self.registry.clock()
        span = (self.tracer.span("serve.artifact_hydrate", kind="program",
                                 fingerprint=fingerprint)
                if self.tracer is not None else None)
        try:
            if span is not None:
                span.__enter__()
            path = os.path.join(d, "manifest.json")
            if not os.path.exists(path):
                self._misses.inc(kind="program")
                return None
            manifest = _read_json(path)
            _check_header(manifest, path)
            raws: Dict[str, bytes] = {}
            for name in _PROGRAM_FILES:
                fpath = os.path.join(d, name)
                if not os.path.exists(fpath):
                    raise ArtifactError(f"{d}: missing {name}")
                with open(fpath, "rb") as f:
                    raws[name] = f.read()
                want = manifest.get("files", {}).get(name)
                got = _sha256(raws[name])
                if want != got:
                    raise ArtifactError(
                        f"{d}/{name}: sha256 mismatch (manifest {want}, "
                        f"file {got}): corrupt or tampered")
            program_doc = json.loads(raws["program.json"].decode())
            entries = json.loads(raws["weights.json"].decode())
            prepared = codec.decode_weights(entries, raws["weights.bin"],
                                            device=device)
            program = codec.decode_program(program_doc, prepared)
            recomputed = program.fingerprint()
            claimed = manifest.get("fingerprint")
            if recomputed != fingerprint or claimed != fingerprint:
                raise ArtifactError(
                    f"{d}: fingerprint mismatch: requested {fingerprint}, "
                    f"manifest claims {claimed}, content hashes to "
                    f"{recomputed}; refusing to hydrate a program that is "
                    "not what it says it is")
            self._hits.inc(kind="program")
            self._hydrate_seconds.inc(self.registry.clock() - t0,
                                      kind="program")
            return program
        except _Foreign as e:
            self._misses.inc(kind="program")
            self._event("serve.artifact_foreign", kind="program",
                        fingerprint=fingerprint, error=str(e))
            return None
        except (ArtifactError, ArtifactCodecError,
                json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            self._invalid.inc(kind="program")
            self._misses.inc(kind="program")
            self._event("serve.artifact_invalid", kind="program",
                        fingerprint=fingerprint, error=str(e))
            return None
        finally:
            if span is not None:
                span.__exit__(None, None, None)

    def load_program_for(self, request_key: str, *,
                         device: "str | torch.device" = "cuda"
                         ) -> "Optional[SynthesizedProgram]":
        """Index lookup + hydrate in one step (what ``synthesize`` calls)."""
        fp = self.lookup(request_key)
        if fp is None:
            self._misses.inc(kind="program")
            return None
        return self.load_program(fp, device=device)

    # -- Stage-D executables: plan-only --------------------------------------
    def put_executable(self, program: "SynthesizedProgram",
                       batch: int) -> bool:
        """Persist one Stage-D bucket; ``False`` (plan-only, a trace event)
        when the codec cannot export it, which in the port is always."""
        try:
            codec.export_executable(program, batch)   # raises: no format
        except ArtifactCodecError as e:
            self._event("serve.artifact_plan_only",
                        fingerprint=program.fingerprint(), batch=batch,
                        error=str(e))
        return False

    def load_executable(self, program: "SynthesizedProgram",
                        batch: int) -> "Optional[BatchProgram]":
        """Hydrate one Stage-D bucket, or None (the caller builds it).

        The port has no format for a CUDA graph and hydrates none: every
        call is a ``kind=executable`` miss, never invalid, whatever the
        program's directory holds (the reference's plan-only fallback).
        """
        self._misses.inc(kind="executable")
        self._event("serve.artifact_plan_only",
                    fingerprint=program.fingerprint(), batch=batch,
                    error=codec.PLAN_ONLY_REASON)
        return None

    def __repr__(self) -> str:
        return f"ArtifactStore({self.root!r})"
