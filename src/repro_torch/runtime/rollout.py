"""Batched closed-loop rollouts over the cached SE(2) decode path (port of
``repro/runtime/rollout.py``).

Fixed scene slots advance in lockstep: each tick samples an action per
agent from the previous logits, integrates unicycle kinematics, and decodes
the A new agent tokens against the slots' stacked K/V cache
(``AgentSimModel.step``). The whole tick runs on the device.

Sampling reproduces the reference's ``jax.random`` stream bit for bit:
lane (scene, sample) holds the key ``fold_in(fold_in(key(seed), scene),
sample)`` (:func:`rollout_keys`), and tick t samples
``categorical(fold_in(key, t), logits)`` (:mod:`repro_torch.prng`), in one
launch of the ``categorical`` kernel on the card. So futures do not depend
on the slot count or on chunking, and a lane's actions equal the
reference's wherever no two actions' perturbed scores lie within the two
frameworks' float32 ``log`` of each other.

Telemetry (``registry=``, :mod:`repro_torch.obs`) as in the reference: spans
``rollout.prefill`` / ``rollout.step`` / ``rollout.chunk`` on the host
clock around the asynchronous launches, the ``rollout.ticks`` counter and
the ``rollout.cache_bytes`` gauge from shape metadata. No instrument reads
a device value, so telemetry adds no synchronisation and obs-on and
obs-off rollouts are bitwise equal. The reference's compiled-cost
wrappers (``CostAccounted``) are not ported yet (ROADMAP A10).

Fleet rollouts (``mesh=``, a ("pod", "data") mesh of
:mod:`repro_torch.launch.mesh`): the slots split over the mesh's ranks,
each running every chunk on its own block of lanes with a replica of the
model, and the futures and actions are all-gathered in rank order, so
every rank returns the whole result. Keys come from each lane's global
index, so a lane's future does not depend on which rank ran it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import obs, prng
from repro_torch.core.kinematics import step_kinematics
from repro_torch.device import resolve_device
from repro_torch.kernels.categorical import categorical
from repro_torch.launch.mesh import mesh_shape
from repro_torch.scenarios.core import ScenarioConfig

# the scene axes a fleet mesh may carry (lanes split over both)
FLEET_AXES = ("pod", "data")


def rollout_keys(seed: int, n_scenes: int, n_samples: int,
                 device=None) -> torch.Tensor:
    """The per-(scene, sample) key data (n_scenes * n_samples, 2) int64 the
    engine samples with, scene-major: the reference's ``rollout_keys``
    (``fold_in(fold_in(key(seed), scene), sample)``) bit for bit."""
    scene = torch.arange(n_scenes, dtype=torch.int64).repeat_interleave(
        n_samples)
    sample = torch.arange(n_samples, dtype=torch.int64).repeat(n_scenes)
    base = prng.key(seed).expand(scene.shape[0], 2)
    keys = prng.fold_in(prng.fold_in(base, scene), sample)
    return keys.to(device)


class RolloutEngine:
    """Closed-loop simulation over fixed slots with cached incremental
    decode. One slot = one (scene, sample) rollout; ``run`` chunks any
    workload over ``num_slots`` lanes."""

    def __init__(self, model, scen_cfg: ScenarioConfig, *, num_slots: int,
                 max_len: Optional[int] = None, cache_dtype=None,
                 decode_impl: Optional[str] = None, device=None,
                 mesh=None, registry: Optional[obs.Registry] = None):
        """``cache_dtype``: "float32" (default) / "bfloat16" / "int8"
        storage of the K/V cache. ``decode_impl`` overrides the model's
        decode attention backend (``ops.decode_attention`` names).
        ``device``: default ``cuda``; must be the model's device.
        ``mesh``: a scene-axis mesh carrying the axes of
        :data:`FLEET_AXES` only (``make_fleet_mesh``); ``num_slots`` is
        rounded up to a multiple of its ranks, each of which runs
        ``num_slots / ranks`` lanes of every chunk (its block, in rank
        order) and gets the gathered result.
        ``registry``: telemetry home, ``None`` the process default,
        ``obs.NULL`` off."""
        self.obs = registry if registry is not None else obs.get_registry()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.scen = scen_cfg
        self.mesh = mesh
        self.num_slots = num_slots
        self.shards, self.shard = 1, 0
        if mesh is not None:
            sizes = mesh_shape(mesh)
            extra = [a for a, n in sizes.items()
                     if a not in FLEET_AXES and n > 1]
            if extra or not any(a in sizes for a in FLEET_AXES):
                raise ValueError(f"fleet mesh must carry only the scene axes "
                                 f"{FLEET_AXES}; got {sizes} (not scene "
                                 f"axes: {extra})")
            coord = mesh.get_coordinate()
            if coord is None:
                raise ValueError("this rank is not in the fleet mesh")
            for i, n in enumerate(sizes.values()):
                self.shards *= n
                self.shard = self.shard * n + coord[i]
            self.num_slots = -(-num_slots // self.shards) * self.shards
        # lanes this process runs of each chunk
        self.local_slots = self.num_slots // self.shards
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
        cache = self.model.init_cache(self.local_slots, self.max_len,
                                      self.cache_dtype)
        # shape metadata only: no device read
        self.obs.gauge("rollout.cache_bytes").set(
            sum(t.numel() * t.element_size() for t in cache.values()))
        return cache

    def _advance(self, cache, acts, pose, speed, feats_proto, valid,
                 t: Union[int, torch.Tensor]):
        """Integrate the actions ``acts`` (B, A) into the poses of step
        ``t`` (an int, or (B,) int32) and decode the new agent tokens;
        returns (cache, logits, pose, speed). Invalid agents stay frozen
        and enter segment-masked."""
        if not isinstance(t, torch.Tensor):
            t = torch.full((acts.shape[0],), t, dtype=torch.int32,
                           device=acts.device)
        ai = torch.div(acts, self.scen.yaw_bins, rounding_mode="floor")
        yi = acts % self.scen.yaw_bins
        new_pose, new_speed = step_kinematics(pose, speed, self._accel[ai],
                                              self._yaw[yi])
        pose = torch.where(valid[..., None], new_pose, pose)
        speed = torch.where(valid, new_speed, speed)
        feats = feats_proto.clone()
        feats[..., 0] = speed / 10.0
        logits, cache = self.model.step(cache, feats, pose, valid, t,
                                        impl=self.decode_impl)
        return cache, logits, pose, speed

    def _step_body(self, cache, logits, pose, speed, feats_proto, valid,
                   lane_keys, t: int):
        """One engine tick on the device: sample from the previous logits
        (float32, as the reference casts them), then integrate and decode
        (:meth:`_advance`)."""
        t_vec = torch.full((logits.shape[0],), t, dtype=torch.int32,
                           device=logits.device)
        acts = categorical(lane_keys, t_vec,
                           logits.to(torch.float32).contiguous())
        cache, logits, pose, speed = self._advance(
            cache, acts, pose, speed, feats_proto, valid, t_vec)
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
        # the per-(scene, sample) stream is fixed up front, on the host
        keys_all = rollout_keys(seed, n_scenes, n_samples)
        futures, actions = [], []
        mine = slice(self.shard * self.local_slots,
                     (self.shard + 1) * self.local_slots)
        for start in range(0, total, self.num_slots):
            # pad the tail chunk by repeating the last lane; this process
            # runs its block of the chunk's lanes
            lanes = np.minimum(start + np.arange(self.num_slots),
                               total - 1)[mine]
            hist = {}
            for key in keys:
                arrs = [scenes[i // n_samples][key] for i in lanes]
                if key.startswith("agent"):
                    arrs = [a[:t_hist] for a in arrs]
                hist[key] = torch.as_tensor(np.stack(arrs),
                                            device=self.device)
            lane_keys = keys_all[torch.from_numpy(lanes)].to(self.device)
            with self.obs.span("rollout.chunk"):
                fut, acts = self._run_chunk(hist, lane_keys, t_hist,
                                            t_total)
                if self.mesh is not None:
                    fut, acts = self._gather(fut), self._gather(acts)
                futures.append(fut[:total - start].cpu().numpy())
                actions.append(acts[:total - start].cpu().numpy())
        t_fut = t_total - t_hist
        a = self.scen.num_agents
        self.last_actions = np.concatenate(actions, 0).reshape(
            n_scenes, n_samples, t_fut, a)
        return np.concatenate(futures, 0).reshape(n_scenes, n_samples,
                                                  t_fut, a, 3)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's lanes of ``x``, concatenated in rank order: an
        all-gather over each mesh axis, the last axis first (over gloo
        through host memory)."""
        staged = x.is_cuda and dist.get_backend() != "nccl"
        out = x.cpu() if staged else x
        for axis in reversed(self.mesh.mesh_dim_names):
            group = self.mesh.get_group(axis)
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, 0)
        return out.to(x.device) if staged else out
