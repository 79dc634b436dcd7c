"""Error hierarchy for the framework.

Mirrors the reference's active `StructureError` enum (error.rs:9-21):
Io, MissingValue, InvalidState, InvalidCsvFormat. The vestigial
simdjson-copied `ErrorType` (error.rs:46-157) is unreachable in the
reference's live path and is intentionally not reproduced.

The port's own copy of csv_simd_tpu/errors.py;
it imports nothing of that package.
"""


class StructureError(Exception):
    """Base error for the CSV structural-indexing pipeline."""


class IoError(StructureError):
    """Failed to open / read the input (reference: error.rs Io variant)."""


class MissingValue(StructureError):
    """A required value is absent (reference: error.rs MissingValue)."""


class InvalidState(StructureError):
    """Internal invariant violated, e.g. uninitialised tape metadata
    (reference: error.rs InvalidState)."""


class InvalidCsvFormat(StructureError):
    """The CSV violates the uniform-stride invariant: the structural index
    length minus the sentinel is not divisible by the record jump size
    (reference: tape.rs:327,342-344)."""
