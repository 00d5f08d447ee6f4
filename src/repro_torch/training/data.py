"""Expert-demonstration batches for behaviour cloning (port of
``repro/training/data.py``; numpy only).

Batches satisfy the :class:`repro_torch.data.ShardedIterator` contract:
``make_batch(seed, start_index, batch_size)`` is a pure function of its
arguments, so the stream is deterministic and restartable from its integer
cursor. Families are interleaved by index, every scene pads to the config's
static shapes, and validity masks carry the per-scene variation.

``families=None`` means every registered family. Only ``freeform`` is
registered in the port so far (see ROADMAP.md), so ``None`` draws freeform
scenes only, where the reference would mix all seven families; pass
``families=("freeform",)`` to both packages to compare them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import ScenarioConfig

__all__ = ["TRAIN_KEYS", "make_sim_batch", "make_batch_fn",
           "holdout_batches", "HOLDOUT_SEED_OFFSET"]

# the model-facing subset of a Scene's tensors, plus the action labels and
# the loss mask
TRAIN_KEYS = ("map_feats", "map_pose", "map_valid",
              "agent_feats", "agent_pose", "agent_valid", "actions")

# held-out batches draw from a far-away seed (index offsets would collide
# with the training stream under another world or batch size)
HOLDOUT_SEED_OFFSET = 100_003


def make_sim_batch(seed: int, start_index: int, batch_size: int,
                   scen: ScenarioConfig,
                   families: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """One expert batch with the ShardedIterator signature: the TRAIN_KEYS
    dict of stacked arrays, map_feats (B, M, Fm), map_pose (B, M, 3),
    map_valid (B, M), agent_feats (B, T, A, Fa), agent_pose (B, T, A, 3),
    agent_valid (B, T, A), actions (B, T, A) int32."""
    batch = registry.generate_mixed_batch(seed, start_index, batch_size,
                                          scen, families)
    return {k: batch[k] for k in TRAIN_KEYS}


def make_batch_fn(scen: ScenarioConfig,
                  families: Optional[Sequence[str]] = None):
    """Bind config and families into the pure ``(seed, index, batch) ->
    dict`` the ShardedIterator consumes."""
    fams = tuple(families) if families is not None else None

    def make_batch(seed: int, start_index: int, batch_size: int):
        return make_sim_batch(seed, start_index, batch_size, scen, fams)

    return make_batch


def holdout_batches(scen: ScenarioConfig, batch_size: int, n_batches: int,
                    seed: int = 0,
                    families: Optional[Sequence[str]] = None):
    """Deterministic held-out batches for open-loop evaluation, on a seed
    stream disjoint from any training cursor position."""
    return [make_sim_batch(seed + HOLDOUT_SEED_OFFSET, i * batch_size,
                           batch_size, scen, families)
            for i in range(n_batches)]
