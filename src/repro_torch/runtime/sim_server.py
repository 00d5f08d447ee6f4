"""Continuous-batching simulation service: mid-flight scene admission (port
of ``repro/runtime/sim_server.py``, one device).

Where :class:`~repro_torch.runtime.rollout.RolloutEngine` runs one batch of
scenes start to finish in lockstep, the server is long-lived: scenes are
admitted into free slots and retired at their horizon while every other
slot keeps ticking.

* **Slab KV cache.** All concurrent scenes share one layer-stacked
  ``(L, B, H, S_slab, .)`` cache (float32 / bfloat16 / int8 with scales),
  updated in place. A retiring scene frees its slot at once; the
  successor's rows overwrite the prefix. Rows the predecessor left past the
  reset cursor are not scrubbed: every decode masks key positions >=
  ``kv_length = cursor + n``, and the cursor only ever advances over
  freshly written rows, so they are unreachable (``docs/serving.md``).

* **Streamed prefill through the shared tick.** Admission writes only the
  scene's M map tokens (``AgentSimModel.admit_map`` on a 1-slot
  sub-cache, installed with ``install_slot_rows``); the history then
  streams through the same tick as every other slot, one teacher-forced
  step a tick. A slot mid-prefill coexists with slots mid-rollout, and
  eviction is legal at any tick.

* **Isolation under churn.** A lane's sampling key is
  ``fold_in(fold_in(key(seed), scene_id), sample_id)``, folded with the
  slot's own sim step each tick (:mod:`repro_torch.prng`, the reference's
  ``jax.random`` stream), so a lane is keyed exactly like the engine's lane
  ``(scene_id, sample_id)``. Every kernel on the tick is row-independent
  and bitwise repeatable, so at a fixed slot count a lane's actions and
  poses do not depend on its slot, its co-residents, its arrival order or
  the garbage in stale rows.

* **Host/device pipelining.** ``tick()`` only enqueues work: its host
  inputs go to the card from pinned memory with asynchronous copies, its
  outputs come back into pinned host buffers behind a CUDA event, and the
  host reads them ``drain_lag`` ticks later, waiting on that event alone.
  PyTorch's pinned-memory allocator keeps a block until the copies that
  read it have finished, so no buffer is overwritten while a copy may
  still read it.

* **Per-slot health / quarantine.** The drain checks every routed lane's
  poses and action ids on the host. A poisoned lane (non-finite state) is
  delivered at once with ``status="failed"`` and a reason, its slot is
  scrubbed back to the fresh-cache values and freed, and the
  ``sim_server.quarantined`` counter and a ``sim_server.quarantine`` event
  record it. Healthy slots keep serving bitwise what a fault-free run
  serves: every kernel masks with a select after the score, so even
  non-finite stale rows do not leak.

The reference jits its tick and admission and counts their compilations;
eager PyTorch compiles nothing, so ``stats()`` reports 0 for both. The
port's guard on the hot loop is its launches: exactly the model step's
kernels a tick and a map prefill's an admission, however the slots churn.
The tick and the admission bodies are ``obs.CostAccounted`` under
``"sim_server.tick"`` and ``"sim_server.admit"``: their first calls'
FLOPs and bytes land as ``cost.*`` gauges, counted from shapes alone.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.core.kinematics import step_kinematics
from repro_torch.device import resolve_device
from repro_torch.kernels.categorical import categorical
from repro_torch.nn.agent_sim import install_slot_rows
from repro_torch.scenarios.core import ScenarioConfig

__all__ = ["SceneRequest", "SimResult", "SimServer", "serve_scenes",
           "poisson_drive"]


@dataclasses.dataclass
class SceneRequest:
    """One (scene, sample) rollout lane.

    ``tensors`` is a scene tensor dict (or anything with a ``.tensors``).
    ``t_hist`` history steps are teacher-forced, then the lane rolls out
    closed-loop until step ``t_total`` (default: the scenario config's
    ``num_steps``). The lane's key is ``fold_in(fold_in(key(seed),
    scene_id), sample_id)``, so lane ``(scene_id, sample_id)`` is keyed
    exactly like that lane of ``RolloutEngine.run(..., seed=seed)``.
    ``scene_id`` defaults to ``uid``.
    """
    uid: int
    tensors: Any
    t_hist: int
    t_total: Optional[int] = None
    seed: int = 0
    scene_id: Optional[int] = None
    sample_id: int = 0

    def __post_init__(self):
        if hasattr(self.tensors, "tensors"):
            self.tensors = self.tensors.tensors
        if self.scene_id is None:
            self.scene_id = self.uid


@dataclasses.dataclass
class SimResult:
    uid: int
    t_hist: int
    t_total: int
    future: np.ndarray        # (t_total - t_hist, A, 3) sampled poses
    actions: np.ndarray       # (t_total - t_hist, A) sampled action ids
    # "ok", or "failed" when the lane was quarantined; the partial
    # future/actions up to the failure are kept, zero-filled beyond it
    status: str = "ok"
    reason: str = ""


@dataclasses.dataclass
class _Slot:
    req: Optional[SceneRequest] = None
    t: int = 0                # next sim step this slot will process


class SimServer:
    """Long-lived continuous-batching closed-loop simulation service."""

    def __init__(self, model, scen_cfg: ScenarioConfig, *, num_slots: int,
                 max_len: Optional[int] = None, cache_dtype=None,
                 decode_impl: Optional[str] = None, drain_lag: int = 1,
                 device=None, registry: Optional[obs.Registry] = None):
        """``max_len``: slab width a slot in cache rows (default: the
        config's worst case ``M + num_steps * A``, rounded up to 128 rows
        past 128 as ``RolloutEngine`` does); a request needs
        ``M + t_total * A <= max_len``. ``drain_lag``: ticks a tick's
        outputs stay in flight before the host reads them (1 = double
        buffering; 0 = synchronous). ``cache_dtype`` / ``decode_impl`` as
        in ``RolloutEngine``. ``device``: default ``cuda``; must be the
        model's device.

        ``registry``: telemetry home (``None`` the process default,
        ``obs.NULL`` off). A working tick records a ``sim_server.tick``
        span and the occupancy / resident / queued gauges; admissions
        record ``sim_server.queue_wait.seconds`` (submit to admit) and, once
        a lane's first closed-loop action has drained,
        ``sim_server.first_action.seconds``. Every sample is host
        wall-clock or host bookkeeping: telemetry reads no device value.
        """
        self.obs = registry if registry is not None else obs.get_registry()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.scen = scen_cfg
        self.num_slots = num_slots
        self.cache_dtype = cache_dtype
        self.decode_impl = decode_impl
        self.drain_lag = drain_lag
        max_len = max_len or (scen_cfg.num_map
                              + scen_cfg.num_steps * scen_cfg.num_agents)
        self.max_len = -(-max_len // 128) * 128 if max_len > 128 else max_len
        m = scen_cfg.num_map
        # the admission's 1-slot sub-cache, just wide enough for the map
        # block; allocated once: every admission resets its cursor and
        # rewrites its rows [0, M)
        self._sub_len = -(-m // 128) * 128 if m > 128 else m
        self._sub = model.init_cache(1, self._sub_len, cache_dtype)
        dev = model.device
        self._accel = torch.as_tensor(scen_cfg.accel_values(),
                                      dtype=torch.float32, device=dev)
        self._yaw = torch.as_tensor(scen_cfg.yaw_values(),
                                    dtype=torch.float32, device=dev)

        self.cache = model.init_cache(num_slots, self.max_len, cache_dtype)
        a = scen_cfg.num_agents
        f32 = dict(dtype=torch.float32, device=dev)
        self.state = {
            # the model's logits come in the compute dtype, as the
            # reference's state holds them
            "logits": torch.zeros((num_slots, a, model.cfg.num_actions),
                                  dtype=model.cfg.compute_dtype, device=dev),
            "pose": torch.zeros((num_slots, a, 3), **f32),
            "speed": torch.zeros((num_slots, a), **f32),
            "proto": torch.zeros((num_slots, a, scen_cfg.agent_feat_dim),
                                 **f32),
            "valid": torch.zeros((num_slots, a), dtype=torch.bool,
                                 device=dev),
            # key data of key(0) in every slot, as the reference's
            "keys": prng.key(0, device=dev).repeat(num_slots, 1),
        }
        self.slots = [_Slot() for _ in range(num_slots)]
        self.queue: Deque[SceneRequest] = collections.deque()
        self.done: Dict[int, SimResult] = {}
        self._buf: Dict[int, Dict[str, Any]] = {}       # uid -> fill state
        # drain queue: (routes, acts, pose, event); routes maps batch row ->
        # (uid, future index); acts / pose are host tensors that hold the
        # tick's outputs once ``event`` has completed (None on the CPU)
        self._pending: Deque[Tuple[List[Tuple[int, int, int]], Any, Any,
                                   Any]] = collections.deque()
        self.ticks = 0
        self.admitted = 0
        self.evicted = 0
        self.quarantined = 0
        self._num_actions = int(model.cfg.num_actions)
        self._submit_ts: Dict[int, float] = {}      # uid -> submit wall-time
        # the reference counts its jit traces here; eager PyTorch traces
        # nothing, so the counters exist and stay 0
        self.obs.counter("sim_server.tick_traces")
        self.obs.counter("sim_server.admit_traces")
        self.obs.gauge("sim_server.slab_rows").set(num_slots * self.max_len)
        self.obs.gauge("sim_server.slab_bytes").set(self._slab_bytes())
        # the first tick and admission are counted once (obs/cost.py) and
        # recorded as cost.* gauges; every later call is the bare body
        self._tick = obs.CostAccounted(self._tick_body, "sim_server.tick",
                                       registry=self.obs)
        self._admit = obs.CostAccounted(self._admit_impl, "sim_server.admit",
                                        registry=self.obs)

    def _slab_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # -- host <-> device -----------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the server's device without a host wait: staged
        in pinned memory and copied asynchronously on the card."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _to_host(self, acts: torch.Tensor, pose: torch.Tensor):
        """Start copying a tick's outputs to the host: (acts, pose, event),
        host tensors that hold the values once ``event`` has completed; on
        the CPU they already do and the event is None."""
        if self.device.type != "cuda":
            return acts, pose, None
        host = []
        for x in (acts, pose):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return host[0], host[1], event

    # -- admission / eviction -------------------------------------------------

    def submit(self, req: SceneRequest):
        req.t_total = req.t_total or self.scen.num_steps
        live = self.scen.num_map + req.t_total * self.scen.num_agents
        if live > self.max_len:
            raise ValueError(
                f"request {req.uid}: live length {live} rows exceeds the "
                f"slab width {self.max_len}; raise max_len or shorten "
                f"t_total")
        if not 0 < req.t_hist <= req.t_total:
            raise ValueError(
                f"request {req.uid}: need 0 < t_hist <= t_total, got "
                f"({req.t_hist}, {req.t_total})")
        if req.uid in self._buf or req.uid in self.done \
                or any(s.req is not None and s.req.uid == req.uid
                       for s in self.slots) \
                or any(r.uid == req.uid for r in self.queue):
            raise ValueError(f"duplicate request uid {req.uid}")
        self._submit_ts[req.uid] = time.perf_counter()
        self.obs.counter("sim_server.submitted").inc()
        self.queue.append(req)

    def evict(self, uid: int) -> bool:
        """Cancel a resident or queued request (legal at any tick,
        mid-prefill included). A resident's slot is reusable at once; the
        rows it wrote stay in the slab, unreachable to successors. Returns
        whether the uid was found."""
        for slot in self.slots:
            if slot.req is not None and slot.req.uid == uid:
                slot.req = None
                self._buf.pop(uid, None)
                self.evicted += 1
                self.obs.counter("sim_server.evicted").inc()
                self.obs.event("sim_server.evict", uid=uid, phase="resident")
                return True
        for r in self.queue:
            if r.uid == uid:
                self.queue.remove(r)
                self._submit_ts.pop(uid, None)
                self.obs.event("sim_server.evict", uid=uid, phase="queued")
                return True
        return False

    def _admit_pending(self):
        for si, slot in enumerate(self.slots):
            if slot.req is not None or not self.queue:
                continue
            req = self.queue.popleft()
            now = time.perf_counter()
            submit_ts = self._submit_ts.pop(req.uid, now)
            self.obs.histogram("sim_server.queue_wait.seconds") \
                .record(now - submit_ts)
            key = prng.lane_key(req.seed, req.scene_id, req.sample_id)
            with self.obs.span("sim_server.admit"):
                self._admit(req.tensors, si, key)
            slot.req = req
            slot.t = 0
            t_fut = req.t_total - req.t_hist
            a = self.scen.num_agents
            self._buf[req.uid] = {
                "future": np.zeros((t_fut, a, 3), np.float32),
                "actions": np.zeros((t_fut, a), np.int32),
                "filled": 0, "req": req,
                "admit_ts": time.perf_counter(),
            }
            self.admitted += 1
            self.obs.counter("sim_server.admitted").inc()

    @torch.no_grad()
    def _admit_impl(self, tensors, si: int, key: Tuple[int, int]):
        """Cursor reset, re-arm and map-token install of slot ``si``.

        The map rows are computed on the 1-slot sub-cache (so admission
        writes what the first M rows of a fresh engine's prefill hold) and
        installed over slot ``si``'s prefix. The slot's state is zeroed;
        its first teacher tick supplies the real values.
        """
        with torch.profiler.record_function("sim_server.admit"):
            map_feats, map_pose, map_valid = (
                self._to_device(tensors[k][None])
                for k in ("map_feats", "map_pose", "map_valid"))
            self._sub["cursor"].zero_()
            _, sub = self.model.admit_map(self._sub, map_feats, map_pose,
                                          map_valid, impl=self.decode_impl)
            install_slot_rows(self.cache, sub, si, map_feats.shape[1])
            # fill_, never ``t[si] = value``: into a 0-d view that copies a
            # pageable CPU scalar, which waits on the stream
            for k in ("logits", "pose", "speed", "proto", "valid"):
                self.state[k][si].zero_()
            for w in range(2):
                self.state["keys"][si, w].fill_(key[w])

    # -- the tick -------------------------------------------------------------

    @torch.no_grad()
    def _tick_body(self, tfeats, tpose, tvalid, t, active, teacher):
        """One service tick on the device, every slot in one call; returns
        (acts (B, A) int32, poses (B, A, 3)).

        Rollout slots run the ``RolloutEngine`` step: sample an action per
        agent from the previous step's logits (the slot's key folded with
        its own sim step ``t``, (B,) int32), integrate kinematics, decode
        the new agent tokens against the slab. Teacher (mid-prefill) slots feed their history
        step instead: same token path, same mask. Inactive slots are
        carried along shape-stably: their samples are discarded, their
        state frozen and their cursor restored; the A rows the decode
        wrote for them lie past that cursor and are unreachable.
        """
        st = self.state
        logits, pose, speed = st["logits"], st["pose"], st["speed"]
        proto, valid = st["proto"], st["valid"]
        acts = categorical(st["keys"], t,
                           logits.to(torch.float32).contiguous())  # (B, A)
        ai = torch.div(acts, self.scen.yaw_bins, rounding_mode="floor")
        yi = acts % self.scen.yaw_bins
        new_pose, new_speed = step_kinematics(pose, speed, self._accel[ai],
                                              self._yaw[yi])
        new_pose = torch.where(valid[..., None], new_pose, pose)
        new_speed = torch.where(valid, new_speed, speed)
        tm = teacher[:, None]
        pose_in = torch.where(tm[..., None], tpose, new_pose)
        speed_in = torch.where(tm, tfeats[..., 0] * 10.0, new_speed)
        valid_in = torch.where(tm, tvalid, valid)
        proto_in = torch.where(tm[..., None], tfeats, proto)
        rolled = proto.clone()
        rolled[..., 0] = new_speed / 10.0
        feats_in = torch.where(tm[..., None], tfeats, rolled)
        cur0 = self.cache["cursor"].clone()
        new_logits, self.cache = self.model.step(
            self.cache, feats_in, pose_in, valid_in, t,
            impl=self.decode_impl)
        self.cache["cursor"] = torch.where(active, self.cache["cursor"],
                                           cur0)
        am1, am2 = active[:, None], active[:, None, None]
        self.state = {
            "logits": torch.where(am2, new_logits, logits),
            "pose": torch.where(am2, pose_in, pose),
            "speed": torch.where(am1, speed_in, speed),
            "proto": torch.where(am2, proto_in, proto),
            "valid": torch.where(am1, valid_in, valid),
            "keys": st["keys"],
        }
        return acts.to(torch.int32), pose_in

    def tick(self) -> bool:
        """Admit, advance every resident slot one sim step, retire.

        Returns False when there was nothing to do (no resident or queued
        work). The device work is enqueued asynchronously; its outputs are
        read ``drain_lag`` ticks later.
        """
        t0 = time.perf_counter()
        ticked = self._tick_host()
        # idle polls would swamp the latency histogram with near-zero
        # samples; only working ticks count as spans
        if ticked:
            self.obs.observe_span("sim_server.tick", t0, time.perf_counter())
        return ticked

    def _tick_host(self) -> bool:
        self._admit_pending()
        b, a = self.num_slots, self.scen.num_agents
        active = np.zeros(b, bool)
        teacher = np.zeros(b, bool)
        t_vec = np.zeros(b, np.int32)
        tfeats = np.zeros((b, a, self.scen.agent_feat_dim), np.float32)
        tpose = np.zeros((b, a, 3), np.float32)
        tvalid = np.zeros((b, a), bool)
        routes: List[Tuple[int, int, int]] = []
        for si, slot in enumerate(self.slots):
            req = slot.req
            if req is None:
                continue
            active[si] = True
            t_vec[si] = slot.t
            if slot.t < req.t_hist:
                teacher[si] = True
                tt = req.tensors
                tfeats[si] = tt["agent_feats"][slot.t]
                tpose[si] = tt["agent_pose"][slot.t]
                tvalid[si] = tt["agent_valid"][slot.t]
            else:
                routes.append((si, req.uid, slot.t - req.t_hist))
        if not active.any():
            return False
        with torch.profiler.record_function("sim_server.tick"):
            acts, pose = self._tick(*(self._to_device(x) for x in (
                tfeats, tpose, tvalid, t_vec, active, teacher)))
            if routes:
                self._pending.append((routes, *self._to_host(acts, pose)))
        self.ticks += 1
        for slot in self.slots:
            if slot.req is None:
                continue
            slot.t += 1
            if slot.t >= slot.req.t_total:      # horizon: retire, free slot
                slot.req = None
        self._drain(self.drain_lag)
        if self.obs.enabled:
            m = self.scen.num_map
            live = sum(min(m + s.t * a, self.max_len)
                       for s in self.slots if s.req is not None)
            self.obs.counter("sim_server.ticks").inc()
            self.obs.gauge("sim_server.live_rows").set(live)
            self.obs.gauge("sim_server.occupancy").set(
                live / float(self.num_slots * self.max_len))
            self.obs.gauge("sim_server.resident").set(
                sum(s.req is not None for s in self.slots))
            self.obs.gauge("sim_server.queued").set(len(self.queue))
        return True

    # -- slot health / quarantine ---------------------------------------------

    def _health_reason(self, acts_row: np.ndarray,
                       pose_row: np.ndarray) -> Optional[str]:
        """Host-side check of outputs the drain already holds: a poisoned
        lane shows as non-finite poses (NaN state propagates through the
        kinematics) or action ids outside the action space."""
        if not np.isfinite(pose_row).all():
            return "nonfinite_pose"
        if acts_row.min() < 0 or acts_row.max() >= self._num_actions:
            return "action_out_of_range"
        return None

    @torch.no_grad()
    def _scrub_slot(self, si: int):
        """Reset slot ``si``'s slab rows and carried state to the
        fresh-cache values, in place. Stale rows are unreachable even when
        non-finite; the scrub restores the fresh-cache invariant for the
        next tenant and stops the quarantined slot's frozen NaN state from
        writing more non-finite rows on its (inactive, discarded) ticks."""
        for k in ("k", "v", "k_scale", "v_scale"):
            if k in self.cache:
                self.cache[k][:, si].zero_()
        self.cache["times"][si].zero_()
        self.cache["seg"][si].fill_(-1)
        self.cache["cursor"][si].zero_()
        for k in ("logits", "pose", "speed", "proto", "valid"):
            self.state[k][si].zero_()

    def _quarantine(self, si: int, uid: int, reason: str):
        """Evict a poisoned lane: its result is delivered at once as
        ``failed`` (partial outputs kept), its slot is scrubbed and freed,
        and the event is counted. Healthy slots are untouched."""
        buf = self._buf.pop(uid, None)
        if buf is not None:
            req = buf["req"]
            self.done[uid] = SimResult(
                uid=uid, t_hist=req.t_hist, t_total=req.t_total,
                future=buf["future"], actions=buf["actions"],
                status="failed", reason=reason)
        slot = self.slots[si]
        if slot.req is not None and slot.req.uid == uid:
            slot.req = None
            self._scrub_slot(si)
        self.quarantined += 1
        self.obs.counter("sim_server.quarantined").inc()
        self.obs.event("sim_server.quarantine", uid=uid, slot=si,
                       reason=reason)

    # -- draining -------------------------------------------------------------

    def _drain(self, keep: int):
        """Read all but the newest ``keep`` ticks' outputs on the host,
        health-checking every routed lane; each read waits on its tick's
        event only."""
        while len(self._pending) > keep:
            routes, acts_h, pose_h, event = self._pending.popleft()
            if event is not None:
                event.synchronize()
            acts_np, pose_np = acts_h.numpy(), pose_h.numpy()
            for si, uid, fi in routes:
                buf = self._buf.get(uid)
                if buf is None:                 # evicted mid-flight
                    continue
                reason = self._health_reason(acts_np[si], pose_np[si])
                if reason is not None:
                    self._quarantine(si, uid, reason)
                    continue
                if buf["filled"] == 0:          # lane's first action landed
                    self.obs.histogram("sim_server.first_action.seconds") \
                        .record(time.perf_counter() - buf["admit_ts"])
                buf["future"][fi] = pose_np[si]
                buf["actions"][fi] = acts_np[si]
                buf["filled"] += 1
                req = buf["req"]
                if buf["filled"] == req.t_total - req.t_hist:
                    self.done[uid] = SimResult(
                        uid=uid, t_hist=req.t_hist, t_total=req.t_total,
                        future=buf["future"], actions=buf["actions"])
                    del self._buf[uid]

    def flush(self):
        """Drain every outstanding tick output to the host."""
        self._drain(0)

    def run_until_drained(self, max_ticks: int = 100_000
                          ) -> Dict[int, SimResult]:
        while (self.queue or any(s.req for s in self.slots)) \
                and self.ticks < max_ticks:
            self.tick()
        self.flush()
        return self.done

    # -- accounting -----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Slab accounting and lifecycle counters (host-side; no sync)."""
        m, a = self.scen.num_map, self.scen.num_agents
        live = sum(min(m + s.t * a, self.max_len)
                   for s in self.slots if s.req is not None)
        return {
            "slots": float(self.num_slots),
            "slab_rows": float(self.num_slots * self.max_len),
            "slab_mib": self._slab_bytes() / 2 ** 20,
            "live_rows": float(live),
            "occupancy": live / float(self.num_slots * self.max_len),
            "resident": float(sum(s.req is not None for s in self.slots)),
            "queued": float(len(self.queue)),
            "ticks": float(self.ticks),
            "admitted": float(self.admitted),
            "evicted": float(self.evicted),
            "quarantined": float(self.quarantined),
            # eager PyTorch compiles nothing (the reference counts its jit
            # traces here)
            "tick_compilations": 0.0,
            "admit_compilations": 0.0,
        }

    def postmortem_state(self) -> Dict[str, Any]:
        """Per-slot phase/cursor/scene-id table plus queue/drain state:
        host bookkeeping only, packaged for the flight recorder
        (``repro_torch.obs.FlightRecorder``)."""
        m, a = self.scen.num_map, self.scen.num_agents
        slots = []
        for si, slot in enumerate(self.slots):
            if slot.req is None:
                slots.append({"slot": si, "phase": "idle"})
                continue
            req = slot.req
            buf = self._buf.get(req.uid, {})
            slots.append({
                "slot": si, "uid": req.uid, "scene_id": req.scene_id,
                "sample_id": req.sample_id, "t": slot.t,
                "t_hist": req.t_hist, "t_total": req.t_total,
                "phase": "prefill" if slot.t < req.t_hist else "rollout",
                "cursor_rows": min(m + slot.t * a, self.max_len),
                "filled": int(buf.get("filled", 0)),
            })
        return {"slots": slots,
                "queued_uids": [r.uid for r in self.queue],
                "done_uids": sorted(self.done),
                "pending_drains": len(self._pending),
                "stats": self.stats()}

    def dump_postmortem(self, path: str, *, reason: str = "manual",
                        **context) -> str:
        """Write a flight-recorder bundle (registry tail, snapshot and the
        per-slot table above) to ``path``; returns the path. Works with
        telemetry off: the slot table is always live."""
        fr = obs.FlightRecorder(self.obs)
        fr.add_provider("sim_server", self.postmortem_state)
        return fr.dump(reason=reason, path=path, **context)


def poisson_drive(server: SimServer, requests: Sequence[SceneRequest], *,
                  rate: float, seed: int = 0,
                  warmup_ticks: int = 0) -> Dict[str, Any]:
    """Drive ``server`` with ``requests`` arriving as a Poisson process.

    ``rate`` is the mean arrival rate in requests a *tick*: inter-arrival
    gaps are i.i.d. exponential with mean ``1/rate``, so admissions
    interleave with resident scenes mid-prefill and mid-rollout. Ticks
    until every request has drained. The host wall-clock of each working
    tick (enqueue plus the pipelined drain) lands in a standalone
    :class:`repro_torch.obs.Histogram`, skipping the first
    ``warmup_ticks`` working ticks. Returns ``{"latency": Histogram,
    "ticks": working ticks incl. warm-up, "arrival_ticks": [...]}``.
    """
    rng = np.random.default_rng(seed)
    t_arrive = np.cumsum(rng.exponential(1.0 / rate, len(requests)))
    pending = collections.deque(zip(t_arrive, requests))
    hist = obs.Histogram("poisson_drive.tick.seconds")
    ticked_n = 0
    clock = 0.0
    while pending or server.queue or any(s.req for s in server.slots):
        while pending and pending[0][0] <= clock:
            server.submit(pending.popleft()[1])
        t0 = time.perf_counter()
        ticked = server.tick()
        if ticked:
            if ticked_n >= warmup_ticks:
                hist.record(time.perf_counter() - t0)
            ticked_n += 1
        clock += 1.0
        if not ticked and pending:        # idle gap: jump to next arrival
            clock = max(clock, pending[0][0])
    server.flush()
    return {"latency": hist, "ticks": ticked_n,
            "arrival_ticks": t_arrive.tolist()}


def serve_scenes(server: SimServer, scenes: Sequence, *, t_hist: int,
                 n_samples: int, seed: int = 0,
                 t_total: Optional[int] = None) -> np.ndarray:
    """Engine-shaped entry: push ``scenes x n_samples`` lanes through
    ``server`` and return futures shaped like ``RolloutEngine.run``,
    (n_scenes, n_samples, T_fut, A, 3), lane (si, ki) keyed like the
    engine's lane (si, ki). ``server`` must be idle and is left idle."""
    if server.queue or any(s.req for s in server.slots):
        raise ValueError("serve_scenes needs an idle server")
    base = len(server.done)
    uid0 = (max(server.done) + 1) if server.done else 0
    lanes = []
    for si, scene in enumerate(scenes):
        for ki in range(n_samples):
            uid = uid0 + len(lanes)
            server.submit(SceneRequest(
                uid=uid, tensors=scene, t_hist=t_hist, t_total=t_total,
                seed=seed, scene_id=si, sample_id=ki))
            lanes.append(uid)
    done = server.run_until_drained()
    if len(done) - base != len(lanes):
        raise RuntimeError(f"serve_scenes: {len(done) - base} of "
                           f"{len(lanes)} lanes finished")
    failed = [uid for uid in lanes if done[uid].status != "ok"]
    if failed:
        raise RuntimeError(
            f"serve_scenes: lanes {failed} were quarantined "
            f"({', '.join(sorted({done[u].reason for u in failed}))}); "
            "the stacked futures would silently contain failed lanes")
    fut = np.stack([done[uid].future for uid in lanes])
    t_fut = fut.shape[1]
    return fut.reshape(len(scenes), n_samples, t_fut,
                       server.scen.num_agents, 3)
