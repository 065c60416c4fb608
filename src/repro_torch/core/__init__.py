"""Core serving techniques ported so far: two-microbatch interleaving and
LEP (expert parallelism with early INT8 dispatch). MTP arrives with its
slice."""
from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan  # noqa: F401
from repro_torch.core.microbatch import microbatched  # noqa: F401
