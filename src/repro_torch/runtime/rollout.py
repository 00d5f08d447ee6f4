"""Batched closed-loop rollouts over the cached SE(2) decode path (port of
``repro/runtime/rollout.py``, one device).

Fixed scene slots advance in lockstep: each tick samples an action per
agent from the previous logits, integrates unicycle kinematics, and decodes
the A new agent tokens against the slots' stacked K/V cache
(``AgentSimModel.step``). The whole tick runs on the device.

Sampling is keyed per (scene, sample, step): Gumbel-max over uniforms from
a counter-based hash of (seed, scene, sample, t, agent, action), computed
with int64 tensor ops on the device. So futures do not depend on the slot
count or on chunking. The hash does not reproduce ``jax.random``'s bits.

Telemetry (``registry=``, :mod:`repro_torch.obs`) as in the reference: spans
``rollout.prefill`` / ``rollout.step`` / ``rollout.chunk`` on the host
clock around the asynchronous launches, the ``rollout.ticks`` counter and
the ``rollout.cache_bytes`` gauge from shape metadata. No instrument reads
a device value, so telemetry adds no synchronisation and obs-on and
obs-off rollouts are bitwise equal. The reference's compiled-cost
wrappers (``CostAccounted``) are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kinematics import step_kinematics
from repro_torch.device import resolve_device
from repro_torch.scenarios.core import ScenarioConfig

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2^32
    (the products stay below 2^63, so nothing overflows)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def _combine(h: torch.Tensor, v) -> torch.Tensor:
    """Fold the counter ``v`` into the hash ``h`` (both < 2^32)."""
    return _mix32((h ^ (v + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)))
                  & _M32)


def rollout_keys(seed: int, scene_ids, sample_ids,
                 device=None) -> torch.Tensor:
    """Per-lane stream keys (int64) from (seed, scene index, sample index)."""
    scene = torch.as_tensor(scene_ids, dtype=torch.int64, device=device)
    sample = torch.as_tensor(sample_ids, dtype=torch.int64, device=device)
    base = _mix32(torch.full_like(scene, seed & _M32))
    return _combine(_combine(base, scene), sample)


def gumbel_sample(logits: torch.Tensor, lane_keys: torch.Tensor,
                  t: Union[int, torch.Tensor]) -> torch.Tensor:
    """Categorical samples (B, A) from logits (B, A, K) by Gumbel-max; the
    uniform for (lane, t, agent, action) is a hash of those counters.
    ``t`` is the step of every lane (an int) or of each lane (a (B,)
    integer tensor, as a server's slots are each at their own step)."""
    b, a, k = logits.shape
    dev = logits.device
    if isinstance(t, torch.Tensor):
        t = t.to(torch.int64)
    key = _combine(lane_keys, t)[:, None, None]
    key = _combine(key, torch.arange(a, device=dev)[None, :, None])
    bits = _combine(key, torch.arange(k, device=dev)[None, None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)


class RolloutEngine:
    """Closed-loop simulation over fixed slots with cached incremental
    decode. One slot = one (scene, sample) rollout; ``run`` chunks any
    workload over ``num_slots`` lanes."""

    def __init__(self, model, scen_cfg: ScenarioConfig, *, num_slots: int,
                 max_len: Optional[int] = None, cache_dtype=None,
                 decode_impl: Optional[str] = None, device=None,
                 registry: Optional[obs.Registry] = None):
        """``cache_dtype``: "float32" (default) / "bfloat16" / "int8"
        storage of the K/V cache. ``decode_impl`` overrides the model's
        decode attention backend (``ops.decode_attention`` names).
        ``device``: default ``cuda``; must be the model's device.
        ``registry``: telemetry home, ``None`` the process default,
        ``obs.NULL`` off."""
        self.obs = registry if registry is not None else obs.get_registry()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.scen = scen_cfg
        self.num_slots = num_slots
        max_len = max_len or (scen_cfg.num_map
                              + scen_cfg.num_steps * scen_cfg.num_agents)
        # a multiple of the decode kernels' key-block size, as in the
        # reference; rows past the cursor stay masked
        self.max_len = -(-max_len // 128) * 128 if max_len > 128 else max_len
        self.cache_dtype = cache_dtype
        self.decode_impl = decode_impl
        self._accel = torch.as_tensor(scen_cfg.accel_values(),
                                      dtype=torch.float32, device=model.device)
        self._yaw = torch.as_tensor(scen_cfg.yaw_values(),
                                    dtype=torch.float32, device=model.device)
        self.ticks = 0
        self.last_actions = None      # (S, K, T_fut, A) after each run()

    def init_cache(self):
        cache = self.model.init_cache(self.num_slots, self.max_len,
                                      self.cache_dtype)
        # shape metadata only: no device read
        self.obs.gauge("rollout.cache_bytes").set(
            sum(t.numel() * t.element_size() for t in cache.values()))
        return cache

    def _advance(self, cache, acts, pose, speed, feats_proto, valid, t: int):
        """Integrate the actions ``acts`` (B, A) into step ``t``'s poses
        and decode the new agent tokens; returns (cache, logits, pose,
        speed). Invalid agents stay frozen and enter segment-masked."""
        b = acts.shape[0]
        ai = torch.div(acts, self.scen.yaw_bins, rounding_mode="floor")
        yi = acts % self.scen.yaw_bins
        new_pose, new_speed = step_kinematics(pose, speed, self._accel[ai],
                                              self._yaw[yi])
        pose = torch.where(valid[..., None], new_pose, pose)
        speed = torch.where(valid, new_speed, speed)
        feats = feats_proto.clone()
        feats[..., 0] = speed / 10.0
        t_vec = torch.full((b,), t, dtype=torch.int32, device=acts.device)
        logits, cache = self.model.step(cache, feats, pose, valid, t_vec,
                                        impl=self.decode_impl)
        return cache, logits, pose, speed

    def _step_body(self, cache, logits, pose, speed, feats_proto, valid,
                   lane_keys, t: int):
        """One engine tick on the device: sample from the previous logits,
        then integrate and decode (:meth:`_advance`)."""
        acts = gumbel_sample(logits, lane_keys, t)
        cache, logits, pose, speed = self._advance(
            cache, acts, pose, speed, feats_proto, valid, t)
        return cache, logits, pose, speed, acts

    @torch.no_grad()
    def _run_chunk(self, hist: Dict[str, torch.Tensor], lane_keys,
                   t_hist: int, t_total: int):
        """Roll ``num_slots`` lanes forward from their history; returns
        poses (B, t_total - t_hist, A, 3) and actions (B, T_fut, A)."""
        cache = self.init_cache()
        with self.obs.span("rollout.prefill"):
            hist_logits, cache = self.model.prefill(cache, hist,
                                                    impl=self.decode_impl)
        logits = hist_logits[:, -1]
        pose = hist["agent_pose"][:, -1]
        speed = hist["agent_feats"][:, -1, :, 0] * 10.0
        feats_proto = hist["agent_feats"][:, -1]
        # agents valid at the last history step stay the slot's live set
        valid = hist["agent_valid"][:, -1]
        out, out_acts = [], []
        for t in range(t_hist, t_total):
            # host time of the tick's launches; no added synchronisation
            with self.obs.span("rollout.step"):
                cache, logits, pose, speed, acts = self._step_body(
                    cache, logits, pose, speed, feats_proto, valid,
                    lane_keys, t)
            self.ticks += 1
            self.obs.counter("rollout.ticks").inc()
            out.append(pose)
            out_acts.append(acts)
        return torch.stack(out, 1), torch.stack(out_acts, 1)

    def run(self, scenes: Sequence, *, t_hist: int, n_samples: int,
            seed: int = 0, t_total: Optional[int] = None) -> np.ndarray:
        """Closed-loop rollouts for every scene x sample.

        ``scenes``: scene tensor dicts or ``Scene`` objects. Returns sampled
        future poses (n_scenes, n_samples, t_total - t_hist, A, 3) as numpy;
        the sampled action ids land in ``self.last_actions``,
        (n_scenes, n_samples, t_total - t_hist, A).
        """
        scenes = [s.tensors if hasattr(s, "tensors") else s for s in scenes]
        t_total = t_total or self.scen.num_steps
        n_scenes = len(scenes)
        total = n_scenes * n_samples
        keys = ("map_feats", "map_pose", "map_valid",
                "agent_feats", "agent_pose", "agent_valid")
        futures, actions = [], []
        for start in range(0, total, self.num_slots):
            # pad the tail chunk by repeating the last lane
            lanes = np.minimum(start + np.arange(self.num_slots), total - 1)
            hist = {}
            for key in keys:
                arrs = [scenes[i // n_samples][key] for i in lanes]
                if key.startswith("agent"):
                    arrs = [a[:t_hist] for a in arrs]
                hist[key] = torch.as_tensor(np.stack(arrs),
                                            device=self.device)
            lane_keys = rollout_keys(seed, lanes // n_samples,
                                     lanes % n_samples, self.device)
            with self.obs.span("rollout.chunk"):
                fut, acts = self._run_chunk(hist, lane_keys, t_hist,
                                            t_total)
                futures.append(fut[:total - start].cpu().numpy())
                actions.append(acts[:total - start].cpu().numpy())
        t_fut = t_total - t_hist
        a = self.scen.num_agents
        self.last_actions = np.concatenate(actions, 0).reshape(
            n_scenes, n_samples, t_fut, a)
        return np.concatenate(futures, 0).reshape(n_scenes, n_samples,
                                                  t_fut, a, 3)
