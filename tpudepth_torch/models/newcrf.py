"""NewCRF neural-window FC-CRF stage (``src/newcrf_layers.py:367-433``).

Counterpart of ``tpudepth/models/newcrf.py``: a two-block stage whose
queries and keys both come from the projected unary ``x`` (the encoder
feature) while the attention values are the decoder state ``v``, raw: it is
never normalized and both blocks reuse it. Block 0 uses plain 7x7 windows,
block 1 a cyclic shift of ``window_size // 2`` with the SW-MSA mask. The
stage returns ``norm_crf`` of the blocks' output and nothing else. Module
names follow the reference ``state_dict`` (``proj_x``, ``proj_v``,
``crf_layer.blocks.{i}.attn.qk``, ``...mlp.fc1``, ``norm_crf``), which
``tpudepth/models/torch_import.py::_newcrf_stage`` reads.

The blocks run in one of five modes, with one parameter tree:

- ``row`` (the default, as the JAX package's eval default on its chip): the
  whole block through the ``crf_rowblock_infer`` kernels on the padded (and,
  for the shifted block, rolled) raw x and v, unrolled after;
- ``fused``: the ``window_attn_infer`` kernel with the shift mask, then the
  ``block_epilogue_infer`` kernel on the cropped rows
  (``TPUDEPTH_BLOCK=pair`` in JAX);
- ``pair``: the ``window_attn_infer`` kernel, the out-projection and
  residual as tensor code, and the FFN through the ``mlp_infer`` kernel
  (``TPUDEPTH_BLOCK=pair TPUDEPTH_EPILOGUE=xla``);
- ``block``: the whole block through the ``crf_block_infer`` kernels on the
  raw windows of the zero-padded (and rolled) x and v, reversed, unrolled
  and cropped after (``TPUDEPTH_BLOCK=fused`` in JAX);
- ``plain``: no kernel, the f32 attention composition with the shift mask
  (what the JAX package computes on the CPU).

In ``row`` mode in eval a stage pads x and v once, chains its blocks'
``crf_rowblock_infer`` calls on the padded layout and crops once (the JAX
package's ``padded_io``, ``TPUDEPTH_STAGE_CHAIN=on``,
``tpudepth/models/newcrf.py:357-373``; the same bits as a pad and a crop
around every block). A chained block's x holds the previous block's output
at the pad positions, no longer zeros; the kernel zeroes LN(x) there by
select, so no real token's output depends on what x holds at the pad
positions.

In train mode every mode takes the unfused block, as the JAX package does on
training traces: LN, pad, [roll], windows, ``qk``, attention with the shift
mask, reverse, [unroll], crop, out-projection + residual, LN2, FFN +
residual. In ``row``, ``fused``, ``pair`` and ``block`` the attention is the
training kernel pair ``window_attention`` (``ops/kernels/window_attn.py``)
and the FFN the ``mlp_train`` pair; in ``plain`` both are the f32
compositions under autograd. On CPU tensors the kernels' wrappers run their
plain versions.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from tpudepth_torch.core.mesh import (
    despatialize,
    gathering_mesh,
    input_rows,
    take_rows,
)
from tpudepth_torch.models.layers import Conv, LayerNorm, Linear, Mlp
from tpudepth_torch.models.sam import WindowAttention
from tpudepth_torch.ops.attention import window_cross_attention_packed
from tpudepth_torch.ops.image import nhwc
from tpudepth_torch.ops.kernels.block_infer import crf_block_infer
from tpudepth_torch.ops.kernels.epilogue_infer import block_epilogue_infer
from tpudepth_torch.ops.kernels.rowblock_infer import crf_rowblock_infer
from tpudepth_torch.ops.window import (
    pad_to_window_multiple,
    shifted_window_attention_mask,
    window_partition,
    window_reverse,
    window_valid_mask_on,
)

ATTN_MODES = ("plain", "pair", "fused", "row", "block")


@functools.lru_cache(maxsize=None)
def shift_mask(h: int, w: int, window_size: int, shift_size: int,
               device: torch.device) -> torch.Tensor:
    """The ``[nW, N, N]`` f32 shift mask of an h x w map, on ``device``,
    made once per shape (a host-to-device copy per call would stall the
    stream)."""
    return torch.from_numpy(shifted_window_attention_mask(
        h, w, window_size, shift_size)).to(device)


class WindowAttentionQKfromX(WindowAttention):
    """q and k from the unary windows (``qk``), the raw values as they are,
    and the out-projection ``proj`` (``src/newcrf_layers.py:110-149``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__(dim, num_heads, window_size)
        self.qk = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x_windows: torch.Tensor, v_windows: torch.Tensor,
                mask, kernel: bool, skip_proj: bool = False) -> torch.Tensor:
        """x_windows, v_windows: [BW, N, C]; mask None or [nW, N, N]."""
        q, k = self.qk(x_windows).chunk(2, dim=-1)
        out = window_cross_attention_packed(q * self.scale, k, v_windows,
                                            self.bias(), mask, kernel=kernel,
                                            training=self.training)
        return out if skip_proj else self.proj(out)


class CRFBlock(nn.Module):
    """One (optionally shifted) CRF block on NHWC tensors
    (``src/newcrf_layers.py:152-257``): ``x`` the unary, ``v`` the values."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mode: str = "row"):
        super().__init__()
        if mode not in ATTN_MODES:
            raise ValueError(f"attn mode must be one of {ATTN_MODES}, "
                             f"not {mode!r}")
        self.window_size = window_size
        self.shift_size = shift_size
        self.mode = mode
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttentionQKfromX(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        # MLP ratio 4; the FFN kernels serve the pair mode and train every
        # kernel mode
        self.mlp = Mlp(dim, 4 * dim, kernel=mode != "plain")

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        if self.mode == "row" and not self.training:
            xp, _, _ = pad_to_window_multiple(x, ws)
            vp, _, _ = pad_to_window_multiple(v.to(x.dtype), ws)
            return self.rowblock(xp, vp, h, w)[:, :h, :w, :]
        mask = shift_mask(h, w, ws, ss, x.device) if ss else None
        if self.mode == "block" and not self.training:
            return self._block(x, v, mask)
        n = ws * ws
        fused = self.mode == "fused" and not self.training
        # pad LN(x) after the LayerNorm and the raw v; roll both
        xn, hp, wp = pad_to_window_multiple(self.norm1(x), ws)
        vp, _, _ = pad_to_window_multiple(v, ws)
        if ss:
            xn = torch.roll(xn, (-ss, -ss), dims=(1, 2))
            vp = torch.roll(vp, (-ss, -ss), dims=(1, 2))
        xw = window_partition(xn, ws).reshape(-1, n, c)
        vw = window_partition(vp, ws).reshape(-1, n, c)
        attn = self.attn(xw, vw, mask, kernel=self.mode != "plain",
                         skip_proj=fused)
        attn = window_reverse(attn.reshape(-1, ws, ws, c), ws, hp, wp)
        if ss:
            attn = torch.roll(attn, (ss, ss), dims=(1, 2))
        attn = attn[:, :h, :w, :]
        if fused:
            # proj + residual + LN2 + FFN + residual over the cropped rows:
            # row-wise, so the same values as the proj on the windows
            ap, mlp = self.attn.proj, self.mlp
            out = block_epilogue_infer(
                attn.reshape(b * h * w, c),
                x.reshape(b * h * w, c).to(attn.dtype),
                ap.weight.t(), ap.bias, self.norm2.weight, self.norm2.bias,
                mlp.fc1.weight.t(), mlp.fc1.bias, mlp.fc2.weight.t(),
                mlp.fc2.bias)
            return out.reshape(b, h, w, c)
        y = x + attn
        return y + self.mlp(self.norm2(y))

    def rowblock(self, xp: torch.Tensor, vp: torch.Tensor, h: int,
                 w: int) -> torch.Tensor:
        """The whole block on x and v padded to window multiples (real
        extent h x w), rolled by (-shift, -shift) for the shifted block and
        unrolled after; the output keeps the padded layout (the pad and roll
        copies stay around the kernel, as in the JAX package's
        ``_rowblock``)."""
        ws, ss = self.window_size, self.shift_size
        mask = shift_mask(h, w, ws, ss, xp.device) if ss else None
        if ss:
            xp = torch.roll(xp, (-ss, -ss), dims=(1, 2))
            vp = torch.roll(vp, (-ss, -ss), dims=(1, 2))
        at, mlp = self.attn, self.mlp
        y = crf_rowblock_infer(
            xp.contiguous(), vp.contiguous(),
            (self.norm1.weight, self.norm1.bias), at.qk.weight.t(), at.qk.bias,
            at.bias(), at.proj.weight.t(), at.proj.bias,
            (self.norm2.weight, self.norm2.bias), mlp.fc1.weight.t(),
            mlp.fc1.bias, mlp.fc2.weight.t(), mlp.fc2.bias, mask,
            scale=at.scale, window_size=ws, valid_hw=(h, w, ss))
        return torch.roll(y, (ss, ss), dims=(1, 2)) if ss else y

    def _block(self, x: torch.Tensor, v: torch.Tensor,
               mask) -> torch.Tensor:
        """The whole block on the raw windows of the zero-padded x and v,
        rolled by (-shift, -shift) for the shifted block; reversed, unrolled
        and cropped after (the JAX package's ``_fused_block``)."""
        _, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        n = ws * ws
        xp, hp, wp = pad_to_window_multiple(x, ws)
        vp, _, _ = pad_to_window_multiple(v.to(x.dtype), ws)
        if ss:
            xp = torch.roll(xp, (-ss, -ss), dims=(1, 2))
            vp = torch.roll(vp, (-ss, -ss), dims=(1, 2))
        at, mlp = self.attn, self.mlp
        yw = crf_block_infer(
            window_partition(xp, ws).reshape(-1, n, c),
            window_partition(vp, ws).reshape(-1, n, c),
            (self.norm1.weight, self.norm1.bias), at.qk.weight.t(), at.qk.bias,
            at.bias(), at.proj.weight.t(), at.proj.bias,
            (self.norm2.weight, self.norm2.bias), mlp.fc1.weight.t(),
            mlp.fc1.bias, mlp.fc2.weight.t(), mlp.fc2.bias, mask,
            window_valid_mask_on(h, w, ws, ss, x.device), scale=at.scale)
        y = window_reverse(yw.reshape(-1, ws, ws, c), ws, hp, wp)
        if ss:
            y = torch.roll(y, (ss, ss), dims=(1, 2))
        return y[:, :h, :w, :]


class CRFLayer(nn.Module):
    """The reference's ``BasicCRFLayer``: ``depth`` blocks, every second one
    shifted by ``window_size // 2``, all on the same values."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 depth: int = 2, mode: str = "row"):
        super().__init__()
        self.blocks = nn.ModuleList([
            CRFBlock(dim, num_heads, window_size,
                     shift_size=0 if i % 2 == 0 else window_size // 2,
                     mode=mode)
            for i in range(depth)])

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.training or self.blocks[0].mode != "row":
            for blk in self.blocks:
                x = blk(x, v)
            return x
        # row mode in eval: one pad and one crop a stage (module docstring)
        _, h, w, _ = x.shape
        ws = self.blocks[0].window_size
        xp, _, _ = pad_to_window_multiple(x, ws)
        vp, _, _ = pad_to_window_multiple(v.to(x.dtype), ws)
        for blk in self.blocks:
            xp = blk.rowblock(xp, vp, h, w)
        return xp[:, :h, :w, :]


class NewCRF(nn.Module):
    """NewCRF stage: ``forward(x, v)`` projects the unary ``x`` and the
    values ``v`` (NCHW) to ``embed_dim`` with 3x3 convs, runs the blocks and
    returns ``norm_crf`` of their output (NCHW, channels_last memory).
    Marked by ``core/mesh.py::run_whole_on_rows``, under a model axis it
    takes and gives this rank's rows of inputs split as a model's input
    (equal shards) and computes on the despatialized maps (windows and the
    shift cross the ranks' edges)."""

    def __init__(self, input_dim: int, embed_dim: int, v_dim: int,
                 num_heads: int, window_size: int = 7, depth: int = 2,
                 mode: str = "row"):
        super().__init__()
        self.proj_x = (Conv(input_dim, embed_dim, 3, padding=1)
                       if input_dim != embed_dim else None)
        self.proj_v = (Conv(v_dim, embed_dim, 3, padding=1)
                       if v_dim != embed_dim else None)
        self.crf_layer = CRFLayer(embed_dim, num_heads, window_size, depth,
                                  mode=mode)
        self.norm_crf = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        mesh = gathering_mesh(self)
        if mesh is not None:
            input_rows(x, mesh)
        x, v = despatialize(x, mesh), despatialize(v, mesh)
        if self.proj_x is not None:
            x = self.proj_x(x)
        if self.proj_v is not None:
            v = self.proj_v(v)
        out = self.norm_crf(self.crf_layer(nhwc(x), nhwc(v)))
        return take_rows(out.permute(0, 3, 1, 2), mesh)
