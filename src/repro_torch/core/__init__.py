"""Core serving techniques: two-microbatch interleaving (and its training
analogue, ``microbatched_loss``), LEP (expert parallelism with early INT8
dispatch) and MTP speculative decoding."""
from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan  # noqa: F401
from repro_torch.core.microbatch import (  # noqa: F401
    microbatched,
    microbatched_loss,
)
from repro_torch.core.mtp import (  # noqa: F401
    MTPHead,
    can_fuse_verify,
    fit_draft_head,
    init_mtp_params,
    mtp_step,
    propose_draft,
    sample_greedy,
    sample_top_p,
)
