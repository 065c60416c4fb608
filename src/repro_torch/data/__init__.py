"""Seeded synthetic training data (numpy; no dataset is downloaded)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticCorpus,
    make_batch_iter,
)
