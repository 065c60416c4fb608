"""Core serving techniques ported so far: two-microbatch interleaving.
MTP and LEP arrive with their slices."""
from repro_torch.core.microbatch import microbatched  # noqa: F401
