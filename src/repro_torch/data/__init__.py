"""Host data pipeline and synthetic LM data (copies of
``repro/data/pipeline.py`` and ``repro/data/synthetic_lm.py``)."""
from repro_torch.data import synthetic_lm
from repro_torch.data.pipeline import DataWorkerError, ShardedIterator

__all__ = ["DataWorkerError", "ShardedIterator", "synthetic_lm"]
