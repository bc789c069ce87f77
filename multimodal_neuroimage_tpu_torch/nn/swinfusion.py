"""SwinFusion blocks and stacks (counterpart of multimodal_neuroimage_tpu/nn/swinfusion.py).

Pre-norm Swin-V1 blocks with a learned relative-position bias table, the
bidirectional cross block, the alternating-shift stacks and the RSTB/CRSTB
residual groups. Every block body is one kernel call: K2 (self) or two K3
calls (cross, A<-B then B<-A, both reading the block's input streams). The
token-major <-> window glue is a roll plus a window partition in plain
PyTorch. Parameter names follow the reference torch modules (``attn.qkv``,
``attn_A.kv``, ``blocks.{j}``, ...).

Layouts (``_LAYOUT``, read from ``FUSION_LAYOUT`` at import; tests set the
global): ``std`` (the default) runs the blocks on (B, nW, N, C) windows
through K2/K3. ``bp`` runs them on group-major streams through K7
(ops/fusion_block_bp.py): each stack enters the layout once, (B, L, C) ->
(B/G, L, G*C) with G = ``group_size(B)`` (JAX ``_bp_enter``), every block
rolls and partitions the group-major stream into (B/G, nW, N, G*C) windows,
and the stack leaves once (``_bp_exit``). The stream between stacks stays
token-major. The TPU's ``bpr`` (window-resident glue) and ``xbp`` (a
plain-XLA twin), like its backbone-wide group residency, are not ported.

Training: each block draws its DropPath factors dp (B, 2) (one pair per
direction in the cross block) and then a dropout seed per kernel call from
the step's generator (JAX: nn/swinfusion.py FusionBlock :369-397 and
CrossFusionBlock :537-566), in either layout; ``drop_path`` is the block's
rate from the stack's linspace. With dropout off the two layouts compute
one function; with it on, their masks differ (the bp masks are the JAX bp
kernels').

The bf16 policy (``_POLICY16``, set by the step builders from
``compute_dtype``; JAX ``_POLICY16`` and ``_stream16_active``): each ``bp``
stack casts its streams to bf16 at entry and back at exit, so K7 runs its
bf16 form. JAX gates this on the TPU backend; the port takes the
accelerator's part on every device, so the CPU path is the card's. The
``std`` stacks keep float32 streams under either policy (JAX
models/swinfusion_net.py:122-123); the kernels take the parameters as the
float32 tensors that hold their bf16 roundings (train/state.py
``bf16_weights``), as the JAX kernels take ``f32(p)``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, Mlp,
                                                       draw_seed,
                                                       drop_path_factors,
                                                       window_partition,
                                                       window_reverse)
from multimodal_neuroimage_tpu_torch.nn.swin2d import (_mask_buffer,
                                                       effective_window,
                                                       relative_position_index)
from multimodal_neuroimage_tpu_torch.ops.fusion_block import (
    bias_from_table, fused_cross_fusion_block, fused_fusion_block)
from multimodal_neuroimage_tpu_torch.ops.fusion_block_bp import (
    from_groups, fused_cross_fusion_block_bp, fused_fusion_block_bp,
    group_size, to_groups)

_LAYOUT = os.environ.get("FUSION_LAYOUT") or "std"
# the session's compute policy: True under compute_dtype="bfloat16" (set by
# train/state.py and serve/predictor.py), False for a float32 run
_POLICY16 = False


def _stream16_active() -> bool:
    """Whether the bp stacks run bf16 streams (the bf16 policy)."""
    return _POLICY16


def set_compute_policy(compute_dtype: str) -> None:
    """Set the fusion stacks' stream policy from a config's compute dtype."""
    global _POLICY16
    _POLICY16 = compute_dtype == "bfloat16"


def _layout() -> str:
    """The fusion layout in force: ``std`` or ``bp``; the TPU's other plans
    raise."""
    if _LAYOUT in ("std", "bp"):
        return _LAYOUT
    raise NotImplementedError(
        f"FUSION_LAYOUT={_LAYOUT!r}: the port runs the fusion stacks in the "
        f"std and bp layouts only; bpr (window-resident glue) and xbp (a "
        f"plain-XLA twin) are TPU plans it does not port (ROADMAP "
        f"\"TPU-only machinery is not ported\")")


def to_windows(t: torch.Tensor, resolution: Tuple[int, int], ws: int,
               shift: int) -> torch.Tensor:
    """(B, L, C) tokens -> (B, nW, ws*ws, C) windows after a cyclic shift."""
    H, W = resolution
    t = t.reshape(t.shape[0], H, W, t.shape[-1])
    if shift > 0:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
    return window_partition(t, ws).contiguous()


def from_windows(t: torch.Tensor, resolution: Tuple[int, int], ws: int,
                 shift: int) -> torch.Tensor:
    """Inverse of :func:`to_windows`."""
    H, W = resolution
    t = window_reverse(t, ws, H, W)
    if shift > 0:
        t = torch.roll(t, shifts=(shift, shift), dims=(1, 2))
    return t.reshape(t.shape[0], H * W, t.shape[-1])


class _WindowGeometry(nn.Module):
    """Effective window/shift, shift mask and relative-position index."""

    def __init__(self, input_resolution, window_size: int, shift_size: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.ws, self.shift = effective_window(self.input_resolution,
                                               window_size, shift_size)
        self.register_buffer("attn_mask", _mask_buffer(
            self.input_resolution, self.ws, self.shift), persistent=False)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(self.ws, self.ws).copy()),
            persistent=False)

    def bias(self, table: torch.Tensor) -> torch.Tensor:
        return bias_from_table(table, self.relative_position_index,
                               table.shape[1])

    def windows(self, t: torch.Tensor) -> torch.Tensor:
        return to_windows(t, self.input_resolution, self.ws, self.shift)

    def tokens(self, t: torch.Tensor) -> torch.Tensor:
        return from_windows(t, self.input_resolution, self.ws, self.shift)


def _train_draws(block: nn.Module, B: int, device, generator):
    """(dp, seed) of one kernel call over B subjects: in training the
    (B, 2) DropPath factors and then the dropout seed, from the step's
    generator; at inference (None, 0)."""
    if not block.training:
        return None, 0
    dp = drop_path_factors((B, 2), block.drop_path, generator, device)
    seed = draw_seed(generator) if max(block.rates) > 0.0 else 0
    return dp, seed


def _table(ws: int, heads: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))


class WindowAttention(nn.Module):
    """Parameters of a self block's attention: qkv, proj, bias table."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = _table(ws, num_heads)


class CrossWindowAttention(nn.Module):
    """Parameters of one cross direction: q from this stream, kv from the
    other, proj, bias table."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = _table(ws, num_heads)


class FusionBlock(nn.Module):
    """Pre-norm Swin-V1 self block over (B, L, C) tokens; one K2 call."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 6, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.geom = _WindowGeometry(input_resolution, window_size, shift_size)
        self.rates = (attn_drop, drop)
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, self.geom.ws, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def kernel_params(self):
        a, m = self.attn, self.mlp
        return (self.norm1.weight, self.norm1.bias, a.qkv.weight,
                a.qkv.bias, a.proj.weight, a.proj.bias,
                self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                m.fc2.weight, m.fc2.bias)

    def forward(self, x: torch.Tensor, generator=None,
                group: Optional[int] = None) -> torch.Tensor:
        """x: (B, L, C) tokens, or with ``group`` = G a group-major
        (B/G, L, G*C) stream (K7)."""
        g = self.geom
        dp, seed = _train_draws(self, x.shape[0] * (group or 1), x.device,
                                generator)
        args = (g.windows(x), self.kernel_params(),
                g.bias(self.attn.relative_position_bias_table), g.attn_mask,
                dp, seed, self.rates, self.training)
        out = (fused_fusion_block_bp(*args, group=group) if group
               else fused_fusion_block(*args))
        return g.tokens(out)


class CrossFusionBlock(nn.Module):
    """Bidirectional A<->B window cross-attention block: A attends with k/v
    from B and B with k/v from A, each from the block's input streams, with
    separate norms and MLPs per stream; two K3 calls."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 6, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.geom = _WindowGeometry(input_resolution, window_size, shift_size)
        self.rates = (attn_drop, drop)
        self.drop_path = drop_path
        hidden = int(dim * mlp_ratio)
        for s in ("A", "B"):
            setattr(self, f"norm1_{s}", LayerNorm(dim))
            setattr(self, f"attn_{s}", CrossWindowAttention(
                dim, self.geom.ws, num_heads))
            setattr(self, f"norm2_{s}", LayerNorm(dim))
            setattr(self, f"mlp_{s}", Mlp(dim, hidden, dim))

    def kernel_params(self, s: str, other: str):
        """16 K3 params for stream ``s`` (queries) reading ``other``."""
        n1, n1o = getattr(self, f"norm1_{s}"), getattr(self, f"norm1_{other}")
        a, n2 = getattr(self, f"attn_{s}"), getattr(self, f"norm2_{s}")
        m = getattr(self, f"mlp_{s}")
        return (n1.weight, n1.bias, n1o.weight, n1o.bias, a.q.weight,
                a.q.bias, a.kv.weight, a.kv.bias,
                a.proj.weight, a.proj.bias, n2.weight, n2.bias,
                m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)

    def forward(self, x: torch.Tensor, y: torch.Tensor, generator=None,
                group: Optional[int] = None):
        """x, y: (B, L, C) tokens, or with ``group`` = G group-major
        (B/G, L, G*C) streams (K7)."""
        g = self.geom
        xw, yw = g.windows(x), g.windows(y)
        B = x.shape[0] * (group or 1)
        dp_a, seed_a = _train_draws(self, B, x.device, generator)
        dp_b, seed_b = _train_draws(self, B, x.device, generator)

        def call(q, kv, s, other, dp, seed):
            args = (q, kv, self.kernel_params(s, other),
                    g.bias(getattr(self, f"attn_{s}")
                           .relative_position_bias_table), g.attn_mask, dp,
                    seed, self.rates, self.training)
            return (fused_cross_fusion_block_bp(*args, group=group) if group
                    else fused_cross_fusion_block(*args))

        out_x = call(xw, yw, "A", "B", dp_a, seed_a)
        out_y = call(yw, xw, "B", "A", dp_b, seed_b)
        return g.tokens(out_x), g.tokens(out_y)


class BasicLayerFusion(nn.Module):
    """``depth`` FusionBlocks alternating shift 0 / ws//2; ``drop_path`` has
    one rate a block (none: all 0)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = ()):
        super().__init__()
        dpr = list(drop_path) or [0.0] * depth
        self.blocks = nn.ModuleList(
            FusionBlock(dim, input_resolution, num_heads, window_size,
                        0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                        drop, attn_drop, dpr[i])
            for i in range(depth))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if _layout() == "std":
            for blk in self.blocks:
                x = blk(x, generator)
            return x
        G = group_size(x.shape[0])
        in_dtype = x.dtype
        if _stream16_active():
            x = x.to(torch.bfloat16)
        t = to_groups(x, G)                     # JAX _bp_enter
        for blk in self.blocks:
            t = blk(t, generator, group=G)
        return from_groups(t, G).to(in_dtype)   # JAX _bp_exit


class CrossBasicLayer(nn.Module):
    """``depth`` CrossFusionBlocks alternating shift 0 / ws//2."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = ()):
        super().__init__()
        dpr = list(drop_path) or [0.0] * depth
        self.blocks = nn.ModuleList(
            CrossFusionBlock(dim, input_resolution, num_heads, window_size,
                             0 if i % 2 == 0 else window_size // 2,
                             mlp_ratio, drop, attn_drop, dpr[i])
            for i in range(depth))

    def forward(self, x: torch.Tensor, y: torch.Tensor, generator=None):
        if _layout() == "std":
            for blk in self.blocks:
                x, y = blk(x, y, generator)
            return x, y
        G = group_size(x.shape[0])
        in_dtype = x.dtype
        if _stream16_active():
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        x, y = to_groups(x, G), to_groups(y, G)
        for blk in self.blocks:
            x, y = blk(x, y, generator, group=G)
        return from_groups(x, G).to(in_dtype), from_groups(y, G).to(in_dtype)


class RSTB(nn.Module):
    """Residual group: ``residual_group(x) + x``."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = ()):
        super().__init__()
        self.residual_group = BasicLayerFusion(
            dim, input_resolution, depth, num_heads, window_size, mlp_ratio,
            drop, attn_drop, drop_path)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x + self.residual_group(x, generator)


class CRSTB(nn.Module):
    """Cross residual group: per-modality residual stacks, then the cross
    stack, whose outputs get the post-stack streams added once more."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = ()):
        super().__init__()
        args = (dim, input_resolution, depth, num_heads, window_size,
                mlp_ratio, drop, attn_drop, drop_path)
        self.residual_group_A = BasicLayerFusion(*args)
        self.residual_group_B = BasicLayerFusion(*args)
        self.residual_group = CrossBasicLayer(*args)

    def forward(self, x: torch.Tensor, y: torch.Tensor, generator=None):
        x = x + self.residual_group_A(x, generator)
        y = y + self.residual_group_B(y, generator)
        cx, cy = self.residual_group(x, y, generator)
        return cx + x, cy + y
