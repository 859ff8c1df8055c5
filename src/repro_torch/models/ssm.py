"""Mamba2 / SSD (state-space duality) mixer (the port's copy of the JAX
package's ``models/ssm.py``).

Train/prefill use the SSD chunked form: within a chunk the recurrence is a
small causal attention-like product, computed by K8 ``ssd_intra`` (through
``kernels/ops``) together with each chunk's outgoing state; across chunks a
[B, H, P, N] state is carried by a torch loop, as the reference carries it by
``lax.scan`` outside its Pallas kernel.  Decode is the O(1)-state recurrent
step in plain torch (the reference has no kernel for it either).
ngroups = 1: B and C are shared across heads.

Shapes:
  d_inner = expand * d_model,  H = d_inner / head_dim (P = head_dim), N = ssm_state
  wz, wx   [d_model, d_inner]
  wB, wC   [d_model, N]
  wdt      [d_model, H]
  conv_w   [K, d_inner + 2N]           depthwise causal conv, K = ssm_conv
  A_log, D, dt_bias [H]                float32 whatever the parameter type
  out_proj [d_inner, d_model]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, gated_rmsnorm, stacked_normal, weight_dtype


def init_ssm(cfg, gen: torch.Generator, dtype: torch.dtype, stack: tuple = ()) -> Params:
    d, di, n, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    conv_ch = di + 2 * n
    dev, wt = gen.device, weight_dtype(cfg)

    def per_layer(t: torch.Tensor) -> torch.Tensor:
        return t.expand(stack + t.shape).clone()

    return {
        "wz": stacked_normal(gen, stack, (d, di), d**-0.5, wt),
        "wx": stacked_normal(gen, stack, (d, di), d**-0.5, wt),
        "wB": stacked_normal(gen, stack, (d, n), d**-0.5, wt),
        "wC": stacked_normal(gen, stack, (d, n), d**-0.5, wt),
        "wdt": stacked_normal(gen, stack, (d, h), d**-0.5, wt),
        "conv_w": stacked_normal(gen, stack, (k, conv_ch), k**-0.5, dtype),
        "conv_b": torch.zeros(stack + (conv_ch,), dtype=dtype, device=dev),
        # A in (-16, -1): log-uniform init, as in the paper
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, h, device=dev))),
        "D": torch.ones(stack + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full(stack + (h,), -4.6, dtype=torch.float32, device=dev),  # softplus^-1(0.01)
        "norm_scale": torch.ones(stack + (di,), dtype=dtype, device=dev),
        "out_proj": stacked_normal(gen, stack, (di, d), di**-0.5, wt),
    }


# ---------------------------------------------------------------------------
def ssm_specs(cfg) -> Params:
    """The reference's logical axes of each leaf."""
    return {"wz": ("embed", "inner"), "wx": ("embed", "inner"), "wB": ("embed", None), "wC": ("embed", None),
            "wdt": ("embed", "ssm_heads"), "conv_w": (None, "conv_ch"), "conv_b": ("conv_ch",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",), "dt_bias": ("ssm_heads",), "norm_scale": ("inner",),
            "out_proj": ("inner", "embed")}


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [K, C]; silu activation."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i : i + s, :].to(torch.float32) * w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xbc.dtype)


def _project(cfg, p: Params, u: torch.Tensor):
    """u [B, S, d] -> z, xbc (x, B, C before the conv), dt_raw."""
    z = u @ p["wz"].to(u.dtype)
    x = u @ p["wx"].to(u.dtype)
    bmat = u @ p["wB"].to(u.dtype)
    cmat = u @ p["wC"].to(u.dtype)
    dt_raw = u @ p["wdt"].to(u.dtype)
    return z, torch.cat([x, bmat, cmat], dim=-1), dt_raw


def _split_xbc(cfg, xbc: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]


def ssd_chunked(
    cfg,
    x: torch.Tensor,  # [B, S, H, P]
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus)
    a: torch.Tensor,  # [H]  (negative; A = -exp(A_log))
    init_state: torch.Tensor | None = None,  # [B, H, P, N]
    *,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan. Returns (y [B, S, H, P] f32, final_state [B, H, P, N] f32).

    The intra-chunk output and each chunk's outgoing state come from
    ``ops.ssd_intra`` (K8); the recurrence over chunks and the inter-chunk
    output are computed here, in f32."""
    b, s, h, pdim = x.shape
    n = bmat.shape[-1]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        # Zero-pad to a chunk multiple. dt=0 at padded steps means decay
        # exp(dt*a)=1 and zero state/output contribution, so results over the
        # real prefix (and the carried state) are exact; padded rows are cut.
        x, bmat, cmat, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, bmat, cmat, dt))
    nc = (s + pad) // q

    dt = dt.to(torch.float32)
    a = a.to(torch.float32)
    y_intra, s_chunk = ops.ssd_intra(x, bmat, cmat, dt, a, chunk=q, use_kernel=use_kernel)
    lcum = torch.cumsum(dt.reshape(b, nc, q, h) * a, dim=2)  # [B,nc,Q,H]
    l_last = lcum[:, :, -1]  # [B,nc,H]

    # inter-chunk recurrence over nc chunks
    state = (torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.to(torch.float32))
    decay = torch.exp(l_last)[..., None, None]  # [B,nc,H,1,1]
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = decay[:, c] * state + s_chunk[:, c]
    states_in = torch.stack(states_in, dim=1)  # [B,nc,H,P,N] state entering each chunk

    # inter-chunk contribution: C_q . state_in, decayed to position q
    cc = cmat.reshape(b, nc, q, n).to(torch.float32)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, states_in) * torch.exp(lcum)[..., None]
    y = (y_intra.reshape(b, nc, q, h, pdim) + y_inter).reshape(b, nc * q, h, pdim)
    return y[:, :s], state


def apply_ssm(
    cfg,
    p: Params,
    u: torch.Tensor,  # [B, S, d_model]
    *,
    state: dict[str, torch.Tensor] | None = None,
    decode: bool = False,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Mamba2 block. Train/prefill when decode=False (the state, if given,
    seeds the scan and the new one is returned); a single-token recurrent
    step when decode=True.

    state = {"ssm": [B,H,P,N] f32, "conv": [B,K-1,conv_ch]}
    """
    h, pdim = cfg.n_ssm_heads, cfg.ssm_head_dim
    bsz, s, _ = u.shape
    z, xbc_raw, dt_raw = _project(cfg, p, u)
    a = -torch.exp(p["A_log"])  # [H]

    new_state = None
    if decode:
        if s != 1:
            raise ValueError(f"decode expects one token, got {s}")
        window = torch.cat([state["conv"], xbc_raw], dim=1)  # [B,K,C]
        xbc = F.silu(
            torch.einsum("bkc,kc->bc", window.to(torch.float32), p["conv_w"].to(torch.float32))
            + p["conv_b"].to(torch.float32)
        ).to(u.dtype)[:, None]
        x, bmat, cmat = _split_xbc(cfg, xbc)
        dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])  # [B,H]
        xh = x[:, 0].reshape(bsz, h, pdim).to(torch.float32)
        decay = torch.exp(dt * a)  # [B,H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dt, bmat[:, 0].to(torch.float32), xh)
        ssm_st = decay[:, :, None, None] * state["ssm"].to(torch.float32) + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(torch.float32), ssm_st)
        y = y + p["D"][None, :, None] * xh
        y = y.reshape(bsz, 1, cfg.d_inner).to(u.dtype)
        new_state = {"ssm": ssm_st, "conv": window[:, 1:]}
    else:
        xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
        x, bmat, cmat = _split_xbc(cfg, xbc)
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [B,S,H]
        xh = x.reshape(bsz, s, h, pdim)
        init = state["ssm"] if state is not None else None
        y, fin = ssd_chunked(cfg, xh, bmat, cmat, dt, a, init, use_kernel=use_kernel)
        y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
        y = y.reshape(bsz, s, cfg.d_inner).to(u.dtype)
        if state is not None:
            # The last K-1 conv inputs, left-padded with zeros when the prompt
            # is shorter (the zeros _causal_conv pads with), so that decode
            # continues exactly as the forward over the longer sequence.
            kc = cfg.ssm_conv - 1
            conv = F.pad(xbc_raw[:, max(s - kc, 0):, :], (0, 0, max(kc - s, 0), 0))
            new_state = {"ssm": fin, "conv": conv}

    y = gated_rmsnorm(p["norm_scale"], y, z)
    return y @ p["out_proj"].to(u.dtype), new_state

