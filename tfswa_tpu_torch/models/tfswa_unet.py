"""TFSWA-UNet (counterpart of ``tfswa_tpu/models/tfswa_unet.py``).

Encoder (3 stages) - bottleneck - decoder (3 stages) with additive skips
and a sigmoid mask head.  The public layout is NCHW (B, C, F, T), as in the
JAX model; inside, activations are NHWC in the compute dtype.  LN
statistics, softmax and the sigmoid head run in f32.  The module tree
carries the reference's state_dict names (``encoder_stages.0.0.tsa.attn.
qkv.weight``, ...), so a reference ``.pt`` loads with ``load_state_dict``.

A new model is in eval mode, as the JAX model's ``train=False`` default:
``model.train()`` switches BatchNorm to batch statistics; under autograd
the ``"pallas"`` route sends every row block through B1-train + B2, the
``"pallas_attn"`` route through B4 and the plain attention's VJP, and the
serving-only ``"pallas_int8"`` route raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from .attention import check_attention_impl
from .blocks import DownsampleBlock, TFSWABlock, UpsampleBlock
from .layers import batch_norm, bilinear_resize, conv2d, gelu, init_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class TFSWAUNet(nn.Module):
    """The TFSWA U-Net (the JAX package's ``TFSWAUNet``, its state_dict
    names the reference's).  ``attention_impl`` picks the row-block route
    (see ``ModelConfig``).  On a CUDA device the kernel routes take bf16
    rows only (``dtype=torch.bfloat16``; the float32 default raises there),
    widths in (32, 64, 128, 256), for "pallas" / "pallas_int8" a head dim
    in (4, 8, 16, 32) and an MLP width a multiple of 8, for "pallas_attn"
    2, 4 or 8 heads; their wrappers raise on anything else, with no
    fallback."""

    def __init__(self, in_channels: int, out_channels: int,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (32, 64, 128, 256),
                 window_size: int = 8, shift_size: int = 4, num_heads: int = 8,
                 mlp_ratio: float = 4.0, attention_impl: str = "xla",
                 use_shift_mask: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(depths) != 4 or len(dims) != 4:
            raise ValueError("Expected 4 stages (3 encoder + bottleneck)")
        check_attention_impl(attention_impl)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.attention_impl = attention_impl
        self.dtype = dtype

        def blk(dim: int, i: int) -> TFSWABlock:
            # alternating W-MSA / SW-MSA shift
            return TFSWABlock(dim, window_size, 0 if i % 2 == 0 else shift_size,
                              num_heads, mlp_ratio, attention_impl, use_shift_mask)

        self.stem = nn.Sequential(nn.Conv2d(in_channels, dims[0], 7, 1, 3),
                                  nn.BatchNorm2d(dims[0]), nn.GELU())
        self.encoder_stages = nn.ModuleList(
            nn.ModuleList(blk(dims[s], i) for i in range(depths[s])) for s in range(3))
        self.downsample_layers = nn.ModuleList(
            DownsampleBlock(dims[s], dims[s + 1]) for s in range(3))
        self.bottleneck = nn.ModuleList(blk(dims[3], i) for i in range(depths[3]))
        self.upsample_layers = nn.ModuleList(
            UpsampleBlock(dims[s + 1], dims[s]) for s in (2, 1, 0))
        self.decoder_stages = nn.ModuleList(
            nn.ModuleList(blk(dims[s], i) for i in range(depths[s])) for s in (2, 1, 0))
        self.output_head = nn.Sequential(
            nn.Conv2d(dims[0], dims[0], 3, 1, 1), nn.BatchNorm2d(dims[0]), nn.GELU(),
            nn.Conv2d(dims[0], out_channels, 1), nn.Sigmoid())
        init_weights(self, generator if generator is not None else torch.Generator())
        self.eval()   # the JAX model's default is train=False

    @classmethod
    def from_config(cls, cfg: ModelConfig,
                    generator: Optional[torch.Generator] = None) -> "TFSWAUNet":
        if cfg.dropout > 0.0:
            raise NotImplementedError("dropout (training) is not ported yet")
        if cfg.remat:
            raise NotImplementedError("remat=True is not ported yet (ROADMAP.md)")
        if cfg.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={cfg.param_dtype!r} is not ported (float32 only)")
        return cls(cfg.in_channels, cfg.out_channels, tuple(cfg.depths),
                   tuple(cfg.dims), cfg.window_size, cfg.shift_size, cfg.num_heads,
                   cfg.mlp_ratio, cfg.attention_impl, cfg.use_shift_mask,
                   _DTYPES[cfg.dtype], generator)

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in_channels, F, T) -> (B, out_channels, F, T) sigmoid masks, f32."""
        x = x.permute(0, 2, 3, 1).to(self.dtype)
        x = gelu(batch_norm(conv2d(x, self.stem[0]), self.stem[1]))
        skips = []
        for s in range(3):
            for blk in self.encoder_stages[s]:
                x = blk(x)
            skips.append(x)
            x = self.downsample_layers[s](x)
        for blk in self.bottleneck:
            x = blk(x)
        for d, s in enumerate((2, 1, 0)):
            x = self.upsample_layers[d](x)
            skip = skips[s]
            x = bilinear_resize(x, skip.shape[1:3])
            for i, blk in enumerate(self.decoder_stages[d]):
                x = blk(x, skip if i == 0 else None)
        head = self.output_head
        x = gelu(batch_norm(conv2d(x, head[0]), head[1]))
        x = torch.sigmoid(conv2d(x, head[3]).float())
        return x.permute(0, 3, 1, 2)
