"""Persistent program artifacts: synthesize once, start warm after that.

The port of ``repro.artifacts``.  :class:`ArtifactStore` persists converged
synthesis results (plan, graph, modes, audit reports, prepared weights),
keyed by the program fingerprint.  ``synthesize(artifact_store=...)`` and the
serving tier's :class:`~repro_torch.serving.program_cache.ProgramCache` use
it to skip the fixed-point loop on restart (DESIGN.md §13).  The port's
Stage D is a CUDA graph, which it does not serialize: a warm start captures
it again (plan-only, ``executables_supported()`` is ``False``).
"""
from .codec import ArtifactCodecError, executables_supported
from .store import (ARTIFACT_SCHEMA_VERSION, ArtifactError, ArtifactStore,
                    synthesis_request_key)

__all__ = [
    "ARTIFACT_SCHEMA_VERSION",
    "ArtifactCodecError",
    "ArtifactError",
    "ArtifactStore",
    "executables_supported",
    "synthesis_request_key",
]
