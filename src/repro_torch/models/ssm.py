"""Mamba2 (SSD, state-space duality) block: chunked-parallel prefill and
the recurrent decode step.

PyTorch counterpart of ``repro/models/ssm.py``, used by ``mamba2-370m``
(pure SSM) and ``zamba2-1.2b`` (hybrid), in plain PyTorch in the
reference's order of operations: the reference runs the scan, the
convolutions and the recurrence as plain jnp, so no kernel of its own
replaces them.  The projections go through ``qdot`` (the Q8_0 kernels
under the ``kernel`` strategy): the in-projections ``wz``, ``wx``, ``wB``,
``wC`` through ``qdot_many``, which quantizes their shared input once, and
``out_proj`` through ``norm_qdot`` behind the gated RMSNorm.  ``wdt`` and
the SSM dynamics (convolutions, ``A_log``, ``dt_bias``, ``D_skip``) stay
f32.

Where the reference contracts three operands in one einsum, this module
contracts them pairwise, bounding the intermediates (the intra-chunk
``(b, c, q, q, g, hp)`` weights are 16.8 MB at 1024 tokens, q 128 and 32
heads).  ``jnp.repeat`` of heads over groups is ``repeat_interleave``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn.functional import silu

from repro_torch.core.qlinear import norm_qdot, qdot, qdot_many
from repro_torch.launch.flops import product

ConvState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int       # expand * d_model
    head_dim: int      # P
    n_heads: int       # d_inner // P
    n_groups: int      # G (B/C groups)
    state: int         # N
    conv_width: int    # temporal conv kernel


def make_ssm_dims(d_model: int, state: int, expand: int = 2,
                  head_dim: int = 64, n_groups: int = 1,
                  conv_width: int = 4) -> SSMDims:
    d_inner = expand * d_model
    return SSMDims(d_model=d_model, d_inner=d_inner, head_dim=head_dim,
                   n_heads=d_inner // head_dim, n_groups=n_groups,
                   state=state, conv_width=conv_width)


def init_mamba2_params(leaf, dims: SSMDims, prefix: str,
                       lead: Tuple[int, ...], dev: torch.device):
    """The reference's tree of split projections, each weight made by
    ``leaf(path, shape, scale, dtype=None)`` (a normal draw times
    ``scale``; ``transformer._param_tree``'s contract), stacked on the
    leading axes ``lead``: ``wz``, ``wx`` (d_inner, D), ``wB``, ``wC`` (G N,
    D), ``wdt`` (H, D) f32 and ``out_proj`` (D, d_inner), each times
    1/sqrt(fan-in); the three convolutions (C, W) f32 times 1/sqrt(W) and
    their zero biases; ``A_log = log(linspace(1, 16, H))``, ``dt_bias``
    -2, ``D_skip`` 1 and the gated norm's gamma 1, all f32."""
    h, w = dims.n_heads, dims.conv_width
    gn = dims.n_groups * dims.state
    sd, si = 1.0 / math.sqrt(dims.d_model), 1.0 / math.sqrt(dims.d_inner)
    sc = 1.0 / math.sqrt(w)
    f32 = torch.float32

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=f32, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    return {
        "wz": leaf(f"{prefix}/wz", (*lead, dims.d_inner, dims.d_model), sd),
        "wx": leaf(f"{prefix}/wx", (*lead, dims.d_inner, dims.d_model), sd),
        "wB": leaf(f"{prefix}/wB", (*lead, gn, dims.d_model), sd),
        "wC": leaf(f"{prefix}/wC", (*lead, gn, dims.d_model), sd),
        "wdt": leaf(f"{prefix}/wdt", (*lead, h, dims.d_model), sd, f32),
        "out_proj": leaf(f"{prefix}/out_proj",
                         (*lead, dims.d_model, dims.d_inner), si),
        "conv_x": leaf(f"{prefix}/conv_x", (*lead, dims.d_inner, w), sc, f32),
        "conv_B": leaf(f"{prefix}/conv_B", (*lead, gn, w), sc, f32),
        "conv_C": leaf(f"{prefix}/conv_C", (*lead, gn, w), sc, f32),
        "conv_x_bias": full(0.0, dims.d_inner),
        "conv_B_bias": full(0.0, gn),
        "conv_C_bias": full(0.0, gn),
        "A_log": a_log.expand(*lead, h).contiguous(),
        "dt_bias": full(-2.0, h),
        "D_skip": full(1.0, h),
        "norm": {"gamma": full(1.0, dims.d_inner)},
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    everywhere (``torch.nn.functional.softplus`` returns x itself above its
    threshold of 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _heads_of_groups(t: torch.Tensor, hp: int, dim: int) -> torch.Tensor:
    """(…, G, N) -> (…, G * hp, N) along ``dim``: each group's row repeated
    for its hp heads (``jnp.repeat``: element-wise, heads of one group
    adjacent)."""
    return torch.repeat_interleave(t, hp, dim=dim)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------


def _cat_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.concatenate([a, b], axis=1)``: in the promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, C), w (C, W): causal depthwise conv along S, the taps added
    in order from zero, then the bias."""
    bsz, s, c = x.shape
    wdt = w.shape[1]
    if init_state is None:
        pad = torch.zeros((bsz, wdt - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+W-1, C)
    out = torch.zeros_like(x)
    for i in range(wdt):
        out = out + xp[:, i: i + s, :] * w[:, i]
    return out + b


def _conv_tail(pre_conv: torch.Tensor, conv_state: Optional[torch.Tensor],
               conv_width: int) -> torch.Tensor:
    """The last (conv_width - 1) *pre-conv* inputs: the decode conv state."""
    w1 = conv_width - 1
    s = pre_conv.shape[1]
    if s >= w1:
        return pre_conv[:, s - w1:, :]
    prev = conv_state if conv_state is not None else torch.zeros(
        (pre_conv.shape[0], w1, pre_conv.shape[2]), dtype=pre_conv.dtype,
        device=pre_conv.device)
    return _cat_promoted(prev, pre_conv)[:, -w1:, :]


def _conv_step(new_col: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor, bias: torch.Tensor):
    """new_col (B, C); conv_state (B, W-1, C) -> (out (B, C), the new state
    ``window[:, 1:]``, a fresh tensor: a caller may copy it over
    ``conv_state`` in place)."""
    window = _cat_promoted(conv_state, new_col[:, None, :])
    out = torch.sum(window * w.T[None], dim=1) + bias
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# chunked SSD (prefill)
# ---------------------------------------------------------------------------


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk length: ``min(chunk, s)`` lowered until it
    divides s (a prime s gives 1: s chunks of one token)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def ssd_chunked(x, dt, A, B, C, chunk: int = 128):
    """Chunked state-space-duality scan (Dao & Gu 2024, section 6).

    x (b, s, h, p); dt (b, s, h); A (h,) negative; B / C (b, s, g, n), the
    heads split per group (h = g * hp).  Returns y (b, s, h, p) in x's
    dtype and the final state (b, h, p, n) f32.  The inter-chunk pass is
    the reference's ``lax.scan``: a loop over the s / q chunks."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    hp = h // g
    q = chunk_len(s, chunk)
    c = s // q

    f32 = torch.float32
    xdt = x.to(f32) * dt[..., None].to(f32)                     # (b,s,h,p)
    dA = dt.to(f32) * A.to(f32)                                 # (b,s,h)

    xc = xdt.reshape(b, c, q, g, hp, p)
    dAc = dA.reshape(b, c, q, g, hp)
    Bc = B.to(f32).reshape(b, c, q, g, n)
    Cc = C.to(f32).reshape(b, c, q, g, n)

    seg = torch.cumsum(dAc, dim=2)                              # (b,c,q,g,hp)
    seg_last = seg[:, :, -1]                                    # (b,c,g,hp)

    # --- intra-chunk (quadratic within q); masked in log space before exp
    ldiff = seg[:, :, :, None] - seg[:, :, None, :, :]          # (b,c,i,j,g,hp)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldiff = torch.where(mask[None, None, :, :, None, None], ldiff,
                        torch.full_like(ldiff, -math.inf))
    L = torch.exp(ldiff)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)             # (b,c,i,j,g)
    # "bcijg,bcijgh,bcjghp->bcighp", pairwise (the first pair, which
    # contracts nothing, counted as the reference's dot)
    y_intra = torch.einsum("bcijgh,bcjghp->bcighp",
                           product(cb[..., None] * L, cb, L), xc)

    # --- inter-chunk state passing
    decay_end = torch.exp(seg_last[:, :, None] - seg)           # (b,c,q,g,hp)
    s_chunk = torch.einsum("bcqghp,bcqgn->bcghpn", xc * decay_end[..., None],
                           Bc)
    chunk_decay = torch.exp(seg_last)                           # (b,c,g,hp)

    hstate = torch.zeros((b, g, hp, p, n), dtype=f32, device=x.device)
    h_before = torch.empty((b, c, g, hp, p, n), dtype=f32, device=x.device)
    for ci in range(c):
        h_before[:, ci] = hstate                    # the state before chunk
        hstate = hstate * chunk_decay[:, ci, ..., None, None] + s_chunk[:, ci]

    y_inter = torch.einsum("bcign,bcghpn->bcighp", Cc, h_before) \
        * torch.exp(seg)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), hstate.reshape(b, h, p, n)


def ssd_recurrent_ref(x, dt, A, B, C):
    """O(s n) token-by-token recurrence: the oracle of ``ssd_chunked``."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    hp = h // g
    f32 = torch.float32
    hstate = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dA = torch.exp(dtt.to(f32) * A.to(f32))                 # (b,h)
        Bh = _heads_of_groups(Bt, hp, 1)                        # (b,h,n)
        Ch = _heads_of_groups(Ct, hp, 1)
        hstate = hstate * dA[..., None, None] + \
            (xt.to(f32) * dtt[..., None].to(f32))[..., None] \
            * Bh[:, :, None, :]
        ys.append(torch.sum(hstate * Ch[:, :, None, :], dim=-1))
    return torch.stack(ys, dim=1).to(x.dtype), hstate


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _in_proj(p, x):
    """z, x, B, C (quantized: f32; one quantization of x shared by the four
    under the kernel strategy) and the f32 ``wdt``'s dt in x's dtype."""
    z, xin, Bin, Cin = qdot_many(x, [p["wz"], p["wx"], p["wB"], p["wC"]])
    return z, xin, Bin, Cin, qdot(x, p["wdt"])


def _gated_out(p, y, z, x_dtype) -> torch.Tensor:
    """``qdot(rms_norm(y * silu(z), gamma), out_proj)`` in x's dtype (the
    reference's norm at its default eps, 1e-5): the gated RMSNorm fused
    with the output projection's quantization under the kernel strategy
    (``norm_qdot``)."""
    return norm_qdot(y * silu(z), p["norm"]["gamma"], 1e-5,
                     p["out_proj"]).to(x_dtype)


def mamba2_forward(p, x, dims: SSMDims, chunk: int = 128,
                   conv_state: Optional[ConvState] = None,
                   ssm_state: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (y (B, S, D), (conv_state, ssm_state)): prefill.  A
    carried ``conv_state`` / ``ssm_state`` continues a sequence: the
    carried state enters as a chunk before the first, decayed exactly."""
    bsz, s, _ = x.shape
    d_in, h = dims.d_inner, dims.n_heads
    z, xin, Bin, Cin, dt_raw = _in_proj(p, x)

    cs_x, cs_B, cs_C = (None, None, None) if conv_state is None \
        else conv_state
    xc = _causal_conv(xin, p["conv_x"], p["conv_x_bias"], cs_x)
    Bc = _causal_conv(Bin, p["conv_B"], p["conv_B_bias"], cs_B)
    Cc = _causal_conv(Cin, p["conv_C"], p["conv_C_bias"], cs_C)
    new_conv_state = (_conv_tail(xin, cs_x, dims.conv_width),
                      _conv_tail(Bin, cs_B, dims.conv_width),
                      _conv_tail(Cin, cs_C, dims.conv_width))

    xs = silu(xc).reshape(bsz, s, h, dims.head_dim)
    B = silu(Bc).reshape(bsz, s, dims.n_groups, dims.state)
    C = silu(Cc).reshape(bsz, s, dims.n_groups, dims.state)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, final = ssd_chunked(xs, dt, A, B, C, chunk)
    if ssm_state is not None:
        seg_all = torch.cumsum(dt * A, dim=1)                   # (B,S,H)
        hp = h // dims.n_groups
        Ch = (_heads_of_groups(C, hp, 2) if dims.n_groups > 1
              else C.expand(bsz, s, h, dims.state))
        carry_y = torch.einsum("bshn,bhpn->bshp", Ch.float(),
                               ssm_state.float()) \
            * torch.exp(seg_all)[..., None]
        y = y + carry_y.to(y.dtype)
        total_decay = torch.exp(seg_all[:, -1])                 # (B,H)
        final = final + ssm_state * total_decay[..., None, None]

    y = y + xs * p["D_skip"][:, None]
    y = y.reshape(bsz, s, d_in)
    return _gated_out(p, y, z, x.dtype), (new_conv_state, final)


def mamba2_decode_step(p, x, dims: SSMDims, conv_state: ConvState,
                       ssm_state: torch.Tensor):
    """x (B, D) one token; ``conv_state`` the (x, B, C) rings of the last
    W - 1 pre-conv inputs (B, W-1, ·) f32; ``ssm_state`` (B, H, P, N) f32.
    Returns y (B, D) and the new (conv_state, ssm_state): fresh tensors,
    which the caller may copy over the old in place."""
    b = x.shape[0]
    d_in, h = dims.d_inner, dims.n_heads
    z, xin, Bin, Cin, dt_raw = _in_proj(p, x)

    cs_x, cs_B, cs_C = conv_state
    xc, cs_x = _conv_step(xin, cs_x, p["conv_x"], p["conv_x_bias"])
    Bc, cs_B = _conv_step(Bin, cs_B, p["conv_B"], p["conv_B_bias"])
    Cc, cs_C = _conv_step(Cin, cs_C, p["conv_C"], p["conv_C_bias"])

    xs = silu(xc).reshape(b, h, dims.head_dim)
    B = silu(Bc).reshape(b, dims.n_groups, dims.state)
    C = silu(Cc).reshape(b, dims.n_groups, dims.state)
    dt = softplus(dt_raw.float() + p["dt_bias"])                # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                      # (B,H)

    hp = h // dims.n_groups
    Bh = _heads_of_groups(B, hp, 1)                             # (B,H,N)
    Ch = _heads_of_groups(C, hp, 1)
    new_state = ssm_state * dA[..., None, None] + \
        (xs.float() * dt[..., None])[..., None] * Bh[:, :, None, :]
    y = torch.sum(new_state * Ch[:, :, None, :], dim=-1)        # (B,H,P)
    y = y + xs.float() * p["D_skip"][:, None]
    y = y.reshape(b, d_in)
    out = _gated_out(p, y, z.float(), x.dtype)
    return out, ((cs_x, cs_B, cs_C), new_state)
