"""SAM cross window-attention stage (``src/SAM.py:247-308``).

Counterpart of ``tpudepth/models/sam.py``: a Swin W-MSA whose queries come
from the decoder state and whose keys and values come from the encoder
feature, 7x7 windows without shift, a relative-position bias, an FFN of
ratio 4 and the triple residual ``LN(q_out) + e_proj + q_proj``. Module
names follow the reference ``state_dict`` (``sam_block.attn.q``,
``sam_block.mlp.fc1``, ``norm_sam``, ...); the reference's unused ``proj``
conv (``src/SAM.py:271``) is left out, and ``relative_position_index`` is
not a persistent buffer.

The block runs in one of four modes, with one parameter tree:

- ``fused``: the ``window_attn_infer`` kernel, then the
  ``block_epilogue_infer`` kernel for out-projection, residual, LayerNorm,
  FFN and residual (the JAX package's eval default on its chip);
- ``pair``: the ``window_attn_infer`` kernel, the out-projection and
  residual as tensor code, and the FFN through the ``mlp_infer`` kernel
  (``TPUDEPTH_EPILOGUE=xla`` in JAX);
- ``row``: the whole block through the ``sam_rowblock_infer`` kernels on
  the zero-padded raw x and v (``TPUDEPTH_BLOCK=row`` in JAX);
- ``plain``: no kernel, the f32 attention composition (what the JAX package
  computes on the CPU).

In train mode every mode takes the unfused block, as the JAX package does on
training traces: LN, pad, windows, ``q`` / ``kv``, attention, reverse, crop,
out-projection + residual, LN2, FFN + residual. In ``fused``, ``pair`` and
``row`` the attention is the training kernel pair ``window_attention``
(``ops/kernels/window_attn.py``) and the FFN the ``mlp_train`` pair; in
``plain`` both are the f32 compositions under autograd. On CPU tensors the
kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpudepth_torch.models.layers import Conv, LayerNorm, Linear, Mlp
from tpudepth_torch.ops.attention import window_cross_attention_packed
from tpudepth_torch.ops.image import nhwc
from tpudepth_torch.ops.kernels.epilogue_infer import block_epilogue_infer
from tpudepth_torch.ops.kernels.rowblock_infer import sam_rowblock_infer
from tpudepth_torch.ops.window import (
    pad_to_window_multiple,
    relative_position_index,
    window_partition,
    window_reverse,
)

ATTN_MODES = ("plain", "pair", "fused", "row")


class WindowAttention(nn.Module):
    """The parts of a window attention that SAM and NewCRF share: the
    relative-position bias table, its index (not a persistent buffer), the
    scale of the queries and the out-projection ``proj``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)),
            persistent=False)

    def bias(self) -> torch.Tensor:
        """[heads, N, N] f32 bias, gathered from the table on every call (so
        ``load_state_dict`` can leave nothing stale)."""
        n = self.window_size ** 2
        idx = self.relative_position_index.reshape(-1)
        return (self.relative_position_bias_table[idx]
                .reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous())


class WindowCrossAttentionQKV(WindowAttention):
    """q from the decoder windows, k and v from the encoder windows, and
    the out-projection ``proj``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__(dim, num_heads, window_size)
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x_windows: torch.Tensor, v_windows: torch.Tensor,
                kernel: bool, skip_proj: bool = False) -> torch.Tensor:
        """x_windows, v_windows: [BW, N, C]. Returns the attention output
        [BW, N, C], projected unless ``skip_proj``."""
        q = self.q(x_windows) * self.scale
        k, v = self.kv(v_windows).chunk(2, dim=-1)
        out = window_cross_attention_packed(q, k, v, self.bias(),
                                            kernel=kernel,
                                            training=self.training)
        return out if skip_proj else self.proj(out)


class SAMBlock(nn.Module):
    """Windowed cross-attention + FFN (``src/SAM.py:146-244``) on NHWC
    tensors: ``x`` the decoder state (queries), ``v`` the encoder feature."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 mode: str = "fused"):
        super().__init__()
        if mode not in ATTN_MODES:
            raise ValueError(f"attn mode must be one of {ATTN_MODES}, "
                             f"not {mode!r}")
        self.window_size = window_size
        self.mode = mode
        self.norm1 = LayerNorm(dim)
        self.normv = LayerNorm(dim)
        self.attn = WindowCrossAttentionQKV(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        # MLP ratio 4; the FFN kernels serve the pair mode and train every
        # kernel mode
        self.mlp = Mlp(dim, 4 * dim, kernel=mode != "plain")

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.mode == "row" and not self.training:
            return self._rowblock(x, v)
        b, h, w, c = x.shape
        ws = self.window_size
        n = ws * ws
        fused = self.mode == "fused" and not self.training
        # pad AFTER the LayerNorm: pad tokens are zeros there, so their
        # queries, keys and values are the projections' biases alone
        xn, hp, wp = pad_to_window_multiple(self.norm1(x), ws)
        vn, _, _ = pad_to_window_multiple(self.normv(v), ws)
        xw = window_partition(xn, ws).reshape(-1, n, c)
        vw = window_partition(vn, ws).reshape(-1, n, c)
        attn = self.attn(xw, vw, kernel=self.mode != "plain", skip_proj=fused)
        attn = window_reverse(attn.reshape(-1, ws, ws, c), ws, hp, wp)
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
        y = attn + x
        return y + self.mlp(self.norm2(y))

    def _rowblock(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The whole block on the zero-padded raw x and v, cropped after."""
        _, h, w, _ = x.shape
        ws = self.window_size
        xp, _, _ = pad_to_window_multiple(x, ws)
        vp, _, _ = pad_to_window_multiple(v.to(x.dtype), ws)
        at, mlp = self.attn, self.mlp
        y = sam_rowblock_infer(
            xp.contiguous(), vp.contiguous(),
            (self.norm1.weight, self.norm1.bias),
            (self.normv.weight, self.normv.bias), at.q.weight.t(), at.q.bias,
            at.kv.weight.t(), at.kv.bias, at.bias(), at.proj.weight.t(),
            at.proj.bias, (self.norm2.weight, self.norm2.bias),
            mlp.fc1.weight.t(), mlp.fc1.bias,
            mlp.fc2.weight.t(), mlp.fc2.bias, scale=at.scale, window_size=ws,
            valid_hw=(h, w))
        return y[:, :h, :w, :]


class SAM(nn.Module):
    """SAM stage: ``forward(e, q)`` projects the encoder feature ``e`` and
    the decoder state ``q`` (NCHW) to ``embed_dim`` with 3x3 convs, runs the
    block with queries from q and keys / values from e, and returns
    ``LN(q_out) + e_proj + q_proj`` (NCHW, channels_last memory)."""

    def __init__(self, input_dim: int, embed_dim: int, v_dim: int,
                 num_heads: int, window_size: int = 7, mode: str = "fused"):
        super().__init__()
        self.proj_e = (Conv(input_dim, embed_dim, 3, padding=1)
                       if input_dim != embed_dim else None)
        self.proj_q = (Conv(v_dim, embed_dim, 3, padding=1)
                       if v_dim != embed_dim else None)
        self.sam_block = SAMBlock(embed_dim, num_heads, window_size, mode=mode)
        self.norm_sam = LayerNorm(embed_dim)

    def forward(self, e: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        if self.proj_q is not None:
            q = self.proj_q(q)
        if self.proj_e is not None:
            e = self.proj_e(e)
        qn, en = nhwc(q), nhwc(e)
        out = self.norm_sam(self.sam_block(qn, en)) + en + qn
        return out.permute(0, 3, 1, 2)
