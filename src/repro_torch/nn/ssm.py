"""State-space sequence mixers (port of ``repro/nn/ssm.py``): the
Mamba-style selective SSM (hymba's parallel branch) and RWKV-6 "Finch"
time mixing with data-dependent decay.

Both scan in chunks, as the reference does: a Python loop over the
chunks, parallel work inside each. Inside a Mamba chunk the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` is a Hillis-Steele doubling scan
(log2(chunk) rounds of elementwise work over (B, chunk, d, N)), where the
reference runs ``lax.associative_scan``: the same composition in another
order, so the two agree within rounding, not bitwise. Each Mamba chunk's
body runs under ``torch.utils.checkpoint`` where autograd records (the
reference's ``jax.checkpoint``), so the (B, T, d_inner, N) tensors never
exist at once, forward or backward.

RWKV-6's decay exponentials appear only as ``exp`` of pairwise
differences of the in-chunk cumulative log-decay (``log w <= 0``), never
as ``exp(-cumsum)`` alone; ``log w`` is clipped to ``[min_log_w, -1e-5]``.

A mixer's ``forward(x, state)`` returns ``(y, new_state)``: ``state`` None
(a full forward from zeros) or one layer's recurrent state, a dict of
(B, ...) tensors (Mamba ``{"h", "conv"}``, RWKV ``{"s", "shift"}``).
``init_state`` gives the state of ``layers`` such layers, stacked on a
leading axis (the model's cache updates it in place).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.layers import Dense
from repro_torch.nn.module import ParamSpec, new_parameter

State = Dict[str, torch.Tensor]


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps ``h -> a_t h + b_t`` along dim 1
    (Hillis-Steele): returns (A_t, B_t) with ``h_t = A_t h_0 + B_t``."""
    d, n = 1, a.shape[1]
    while d < n:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return a, b


def _chunks(t: int, chunk: int):
    if t % chunk:
        raise ValueError(f"the chunk {chunk} does not divide {t} steps")
    return range(0, t, chunk)


def diag_ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t for diagonal SSMs.

    a, b (B, T, ...); h0 (B, ...). Returns (h_all (B, T, ...), h_last):
    sequential over T / chunk, a doubling scan within a chunk."""
    outs, h = [], h0
    for t0 in _chunks(a.shape[1], chunk):
        aa, bb = _doubling_scan(a[:, t0:t0 + chunk], b[:, t0:t0 + chunk])
        h_all = aa * h[:, None] + bb
        outs.append(h_all)
        h = h_all[:, -1]
    return torch.cat(outs, 1), h


def _selective_chunk(h, dtc, bc, cc, xcc, a_diag):
    """One chunk of the selective SSM: discretise, scan from ``h``,
    project. dtc (B, L, d), bc / cc (B, L, N), xcc (B, L, d); returns
    (h at the chunk's end (B, d, N), y (B, L, d))."""
    da = torch.exp(dtc[..., None] * a_diag)                  # (B, L, d, N)
    db = dtc[..., None] * bc[:, :, None, :] * xcc.to(torch.float32)[..., None]
    aa, bb = _doubling_scan(da, db)
    h_all = aa * h[:, None] + bb
    y = torch.einsum("bldn,bln->bld", h_all, cc)
    return h_all[:, -1], y


def selective_ssm_fused(dt, bmat, cmat, xc, a_diag, h0, chunk: int = 128):
    """The selective SSM a chunk at a time: discretisation, scan and output
    projection per chunk, each chunk recomputed in the backward.

    dt (B, T, d) float32; bmat / cmat (B, T, N) float32; xc (B, T, d);
    a_diag (d, N) < 0; h0 (B, d, N) float32. Returns y (B, T, d) float32
    and h_last (B, d, N)."""
    ys, h = [], h0
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, bmat, cmat, xc, a_diag, h0))
    for t0 in _chunks(dt.shape[1], chunk):
        part = (h, dt[:, t0:t0 + chunk], bmat[:, t0:t0 + chunk],
                cmat[:, t0:t0 + chunk], xc[:, t0:t0 + chunk], a_diag)
        if remat:
            h, y = checkpoint(_selective_chunk, *part, use_reentrant=False)
        else:
            h, y = _selective_chunk(*part)
        ys.append(y)
    return torch.cat(ys, 1), h


class MambaMixer(nn.Module):
    """Selective state-space mixer (Mamba-1 style, diagonal A)."""

    def __init__(self, d_model: int, d_inner: Optional[int] = None,
                 state_size: int = 16, conv_width: int = 4,
                 dt_rank: Optional[int] = None, chunk: int = 128,
                 device=None):
        super().__init__()
        d = d_model
        di = self.d_inner = d_inner or 2 * d_model
        n = self.state_size = state_size
        r = self.dt_rank = dt_rank or max(16, d_model // 16)
        self.conv_width, self.chunk = conv_width, chunk
        self.in_proj = Dense((d,), (2 * di,), device, in_axes=("embed",),
                             out_axes=("mlp",))
        self.conv = new_parameter(ParamSpec((conv_width, di),
                                            axes=("conv", "mlp")), device)
        self.conv_bias = new_parameter(ParamSpec((di,), init="zeros",
                                                 axes=("mlp",)), device)
        self.x_dt = Dense((di,), (r,), device, in_axes=("mlp",),
                          out_axes=(None,))
        self.dt_proj = Dense((r,), (di,), device, use_bias=True,
                             in_axes=(None,), out_axes=("mlp",))
        self.x_bc = Dense((di,), (2 * n,), device, in_axes=("mlp",),
                          out_axes=("state",))
        self.a_log = new_parameter(ParamSpec((di, n), init="zeros",
                                             axes=("mlp", "state")), device)
        self.d_skip = new_parameter(ParamSpec((di,), init="ones",
                                              axes=("mlp",)), device)
        self.out_proj = Dense((di,), (d,), device, in_axes=("mlp",),
                              out_axes=("embed",))

    def _conv(self, x: torch.Tensor, state: Optional[torch.Tensor]):
        """Causal depthwise conv. x (B, T, di); state (B, W-1, di) or None.
        Returns (out, the last W-1 inputs)."""
        w = self.conv.to(x.dtype)                            # (W, di)
        if state is None:
            pad = x.new_zeros((x.shape[0], self.conv_width - 1, x.shape[2]))
        else:
            pad = state.to(x.dtype)
        xp = torch.cat([pad, x], 1)                          # (B, T+W-1, di)
        t = x.shape[1]
        out = sum(xp[:, i:i + t] * w[i] for i in range(self.conv_width))
        return out + self.conv_bias.to(x.dtype), \
            xp[:, xp.shape[1] - (self.conv_width - 1):]

    def _ssm_inputs(self, xc: torch.Tensor):
        dt = F.softplus(self.dt_proj(self.x_dt(xc)).to(torch.float32))
        bmat, cmat = torch.split(self.x_bc(xc).to(torch.float32),
                                 self.state_size, -1)
        a = -torch.exp(self.a_log.to(torch.float32))          # (di, N) < 0
        return dt, bmat, cmat, a

    def forward(self, x: torch.Tensor, state: Optional[State] = None):
        """x (B, T, d_model); ``state`` None (from zeros) or {"h" (B, di,
        N) float32, "conv" (B, W-1, di)}. Returns (y, {"h", "conv"})."""
        xi, z = torch.split(self.in_proj(x), self.d_inner, -1)
        xc, new_conv = self._conv(xi, None if state is None
                                  else state["conv"])
        xc = F.silu(xc)
        dt, bmat, cmat, a = self._ssm_inputs(xc)
        h0 = (x.new_zeros((x.shape[0], self.d_inner, self.state_size),
                          dtype=torch.float32) if state is None
              else state["h"])
        if x.shape[1] == 1:                  # the one-token decode step
            h_last, y = _selective_chunk(h0, dt, bmat, cmat, xc, a)
        else:
            y, h_last = selective_ssm_fused(dt, bmat, cmat, xc, a, h0,
                                            chunk=min(self.chunk, x.shape[1]))
        y = y + xc.to(torch.float32) * self.d_skip.to(torch.float32)
        y = y.to(x.dtype) * F.silu(z)
        return self.out_proj(y), {"h": h_last, "conv": new_conv}

    def init_state(self, batch: int, dtype, layers: int = 1) -> State:
        dev = self.a_log.device
        return {"h": torch.zeros((layers, batch, self.d_inner,
                                  self.state_size), device=dev),
                "conv": torch.zeros((layers, batch, self.conv_width - 1,
                                     self.d_inner), dtype=dtype, device=dev)}


class RWKV6TimeMix(nn.Module):
    """RWKV-6 time mixing: data-dependent per-channel decay (Finch)."""

    def __init__(self, d_model: int, head_dim: int = 64,
                 decay_lora: int = 64, chunk: int = 16,
                 min_log_w: float = -6.0, device=None):
        super().__init__()
        if d_model % head_dim:
            raise ValueError(f"head_dim {head_dim} does not divide "
                             f"d_model {d_model}")
        d = self.d_model = d_model
        self.head_dim, self.num_heads = head_dim, d_model // head_dim
        self.chunk, self.min_log_w = chunk, min_log_w

        def vec(init, scale=0.02):
            return new_parameter(ParamSpec((d,), init=init, scale=scale,
                                           axes=("embed_no_fsdp",)), device)

        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, vec("uniform", 0.5))
        for name in ("receptance", "key", "value", "gate"):
            setattr(self, name, Dense((d,), (d,), device, in_axes=("embed",),
                                      out_axes=("heads",)))
        self.output = Dense((d,), (d,), device, in_axes=("heads",),
                            out_axes=("embed",))
        self.w0 = vec("uniform", 1.0)
        self.w_lora_a = Dense((d,), (decay_lora,), device, in_axes=("embed",),
                              out_axes=(None,))
        self.w_lora_b = Dense((decay_lora,), (d,), device, in_axes=(None,),
                              out_axes=("heads",))
        self.bonus = vec("uniform", 0.5)
        self.ln_scale = vec("ones")
        self.ln_bias = vec("zeros")

    def _mixed_inputs(self, x, shifted):
        def mix(p):
            return x + (shifted - x) * p.to(x.dtype)

        b, t, _ = x.shape
        h, n = self.num_heads, self.head_dim
        r = self.receptance(mix(self.mix_r)).reshape(b, t, h, n)
        k = self.key(mix(self.mix_k)).reshape(b, t, h, n)
        v = self.value(mix(self.mix_v)).reshape(b, t, h, n)
        g = F.silu(self.gate(mix(self.mix_g)))
        wl = self.w_lora_b(self.w_lora_a(torch.tanh(mix(self.mix_w))))
        log_w = -torch.exp(torch.clamp(
            self.w0.to(torch.float32) + wl.to(torch.float32), -10.0, 1.8))
        log_w = torch.clamp(log_w, self.min_log_w, -1e-5).reshape(b, t, h, n)
        return r, k, v, g, log_w

    @staticmethod
    def _wkv_chunk(s0, r, k, v, lw, u):
        """One chunk of the WKV recurrence. s0 (B, H, N, N); r / k / v / lw
        (B, L, H, N) float32; u (H, N). Returns (s at the chunk's end, y
        (B, L, H, N))."""
        n_steps = r.shape[1]
        la = torch.cumsum(lw, 1)                          # inclusive
        la_excl = la - lw
        # the state from before the chunk, decayed to each step
        y = torch.einsum("blhn,bhnm->blhm", r * torch.exp(la_excl), s0)
        # strictly causal in-chunk terms: decay from s to l, s < l
        expo = la_excl[:, :, None] - la[:, None, :]       # (B, L, S, H, N)
        tri = torch.ones(n_steps, n_steps, dtype=torch.bool,
                         device=r.device).tril(-1)
        expo = torch.where(tri[None, :, :, None, None], expo,
                           torch.tensor(float("-inf"), device=r.device))
        scores = (r[:, :, None] * k[:, None, :] * torch.exp(expo)).sum(-1)
        y = y + torch.einsum("blsh,bshm->blhm", scores, v)
        # the bonus on the diagonal
        y = y + torch.sum(r * u * k, -1)[..., None] * v
        k_dec = k * torch.exp(la[:, -1:] - la)
        s_new = s0 * torch.exp(la[:, -1])[..., None] + torch.einsum(
            "blhn,blhm->bhnm", k_dec, v)
        return s_new, y

    @staticmethod
    def _wkv_step(s, r, k, v, lw, u):
        """One step of the WKV recurrence (the decode path). s (B, H, N, N);
        r / k / v / lw (B, H, N) float32. Returns (s after it, y (B, H,
        N))."""
        y = torch.einsum("bhn,bhnm->bhm", r, s)
        y = y + torch.sum(r * u * k, -1)[..., None] * v
        s = s * torch.exp(lw)[..., None] + torch.einsum("bhn,bhm->bhnm", k, v)
        return s, y

    def forward(self, x: torch.Tensor, state: Optional[State] = None):
        """x (B, T, d); ``state`` None or {"s" (B, H, N, N) float32,
        "shift" (B, d)}. Returns (y, {"s", "shift"})."""
        b, t, d = x.shape
        h, n = self.num_heads, self.head_dim
        if state is None:
            shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
            s = x.new_zeros((b, h, n, n), dtype=torch.float32)
        else:
            shifted = torch.cat([state["shift"][:, None].to(x.dtype),
                                 x[:, :-1]], 1)
            s = state["s"]
        r, k, v, g, lw = self._mixed_inputs(x, shifted)
        u = self.bonus.to(torch.float32).reshape(h, n)
        rf, kf, vf = (z.to(torch.float32) for z in (r, k, v))
        if t == 1:
            s, y = self._wkv_step(s, rf[:, 0], kf[:, 0], vf[:, 0], lw[:, 0],
                                  u)
            y = y[:, None]
        else:
            chunk = min(self.chunk, t)
            ys = []
            for t0 in _chunks(t, chunk):
                sl = slice(t0, t0 + chunk)
                s, yc = self._wkv_chunk(s, rf[:, sl], kf[:, sl], vf[:, sl],
                                        lw[:, sl], u)
                ys.append(yc)
            y = torch.cat(ys, 1)
        # per-head group norm (the population variance, as jnp.var)
        y32 = y.reshape(b, t, h, n).to(torch.float32)
        mu = y32.mean(-1, keepdim=True)
        var = y32.var(-1, keepdim=True, correction=0)
        y32 = (y32 - mu) * torch.rsqrt(var + 64e-5)
        yn = (y32.reshape(b, t, d) * self.ln_scale.to(torch.float32)
              + self.ln_bias.to(torch.float32))
        out = self.output(yn.to(x.dtype) * g)
        return out, {"s": s, "shift": x[:, -1]}

    def init_state(self, batch: int, dtype, layers: int = 1) -> State:
        h, n = self.num_heads, self.head_dim
        dev = self.w0.device
        return {"s": torch.zeros((layers, batch, h, n, n), device=dev),
                "shift": torch.zeros((layers, batch, self.d_model),
                                     dtype=dtype, device=dev)}
