"""Host data pipeline (copy of ``repro/data/pipeline.py``)."""
from repro_torch.data.pipeline import DataWorkerError, ShardedIterator

__all__ = ["DataWorkerError", "ShardedIterator"]
