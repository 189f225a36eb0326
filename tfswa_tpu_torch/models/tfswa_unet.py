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

``remat=True`` (the JAX model's ``nn.remat`` of each ``TFSWABlock``) runs
each block under ``torch.utils.checkpoint`` in train mode with autograd
on: the block keeps only its input and is run again in the backward.  The
recompute leaves the BatchNorm running stats alone (flax updates them
once), and on the ``"pallas"`` route it launches B1-train a second time:
132 B1-train and 66 B2 launches a step instead of 66 and 66.
``remat_policy`` (default ``"none"``; ``"dots"``, ``"dots_no_batch"``,
``"everything"``, the JAX package's names) keeps what that save policy
keeps through the recompute (``optimization/remat.py``).

``dropout`` (the reference's three sites in every row block) is drawn in
train mode when ``forward`` gets a ``generator``: one seed a block from it,
passed into the (checkpointed) block, so that a remat recompute draws the
same masks.  It sends every row block to the plain route, as the JAX
model does.  In eval mode it is a no-op and the kernel routes run.

Under a mesh (``parallel/sharding.shard_model``) ``bn_axis`` is the data
axis, over which every train-mode BatchNorm averages its statistics (the
JAX model's ``bn_axis_name``), and ``tp_axis`` the model axis the row
blocks' weights are split over (``models/attention.py``).
"""
from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from .attention import check_attention_impl
from .blocks import DownsampleBlock, TFSWABlock, UpsampleBlock
from .layers import batch_norm, bilinear_resize, conv2d, frozen_stats, gelu, init_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class TFSWAUNet(nn.Module):
    """The TFSWA U-Net (the JAX package's ``TFSWAUNet``, its state_dict
    names the reference's).  ``attention_impl`` picks the row-block route
    (see ``ModelConfig``; "int8" is the int8-product serving route of
    ``ops/int8.py``).  On a CUDA device the kernel routes take bf16 rows
    (tensor-core kernels) or f32 rows (the f32 kernels), every width a
    multiple of 8 up to 512 with any head count that divides it, and an
    MLP width a multiple of 8; their wrappers raise on anything else
    (float16 rows too), with no fallback.  ``use_shift_mask`` (the Swin mask on the shifted SWA
    blocks) and active dropout send those row blocks to the plain route.
    ``param_dtype`` is every parameter's dtype (the JAX model's: each
    flax param, BatchNorm's scale and bias included, is made in it; the
    running statistics stay f32, as flax keeps them); the compute casts
    the parameters to ``dtype`` where the JAX model casts them."""

    def __init__(self, in_channels: int, out_channels: int,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (32, 64, 128, 256),
                 window_size: int = 8, shift_size: int = 4, num_heads: int = 8,
                 mlp_ratio: float = 4.0, attention_impl: str = "xla",
                 use_shift_mask: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(depths) != 4 or len(dims) != 4:
            raise ValueError("Expected 4 stages (3 encoder + bottleneck)")
        check_attention_impl(attention_impl)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.window_size = window_size
        self.shift_size = shift_size
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.remat = remat
        # what a remat recompute keeps (optimization/remat.py POLICIES)
        self.remat_policy = "none"
        self.dropout = dropout

        def blk(dim: int, i: int) -> TFSWABlock:
            # alternating W-MSA / SW-MSA shift
            return TFSWABlock(dim, window_size, 0 if i % 2 == 0 else shift_size,
                              num_heads, mlp_ratio, attention_impl, use_shift_mask, dropout)

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
        for p in self.parameters():
            p.data = p.data.to(param_dtype)
        self.eval()   # the JAX model's default is train=False

    @classmethod
    def from_config(cls, cfg: ModelConfig,
                    generator: Optional[torch.Generator] = None) -> "TFSWAUNet":
        return cls(cfg.in_channels, cfg.out_channels, tuple(cfg.depths),
                   tuple(cfg.dims), cfg.window_size, cfg.shift_size, cfg.num_heads,
                   cfg.mlp_ratio, cfg.attention_impl, cfg.use_shift_mask,
                   _DTYPES[cfg.dtype], cfg.remat, generator, cfg.dropout,
                   _DTYPES[cfg.param_dtype])

    @property
    def bn_axis(self):
        """The mesh axis train-mode BatchNorm statistics are averaged over
        (None: this process's batch alone)."""
        return getattr(self.stem[1], "sync_axis", None)

    @bn_axis.setter
    def bn_axis(self, axis) -> None:
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.sync_axis = axis

    @property
    def tp_axis(self):
        """The model axis the row blocks' weights are split over, or None."""
        return next((m.tp for m in self.modules() if hasattr(m, "tp")), None)

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def get_model_info(self, params=None) -> dict:
        """The JAX model's info dict, key for key; ``num_parameters`` when
        ``params`` (a mapping or an iterable of tensors, e.g.
        ``model.parameters()``) is given: their element count."""
        info = {
            "architecture": "TFSWA-UNet (tfswa_tpu_torch)",
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "depths": list(self.depths),
            "dims": list(self.dims),
            "num_stages": len(self.depths),
        }
        if params is not None:
            tensors = params.values() if isinstance(params, Mapping) else params
            info["num_parameters"] = int(sum(t.numel() for t in tensors))
        return info

    def clone(self, attention_impl: Optional[str] = None) -> "TFSWAUNet":
        """A deep copy (weights, running stats, mode), with every row block
        on ``attention_impl`` if given (the JAX ``model.clone``)."""
        out = copy.deepcopy(self)
        if attention_impl is not None:
            check_attention_impl(attention_impl)
            for m in out.modules():
                if hasattr(m, "attention_impl"):
                    m.attention_impl = attention_impl
        return out

    def _block(self, blk: TFSWABlock, x: torch.Tensor, skip: Optional[torch.Tensor],
               seed: Optional[int]) -> torch.Tensor:
        from ..optimization.remat import policy_contexts, recomputes

        if not (self.remat and self.training and torch.is_grad_enabled()
                and recomputes(self.remat_policy)):
            return blk(x, skip, seed)
        return checkpoint(blk, x, skip, seed, use_reentrant=False,
                          context_fn=lambda: policy_contexts(self.remat_policy,
                                                            frozen_stats(blk)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, in_channels, F, T) -> (B, out_channels, F, T) sigmoid masks, f32.
        ``generator`` (a CPU ``torch.Generator``): the dropout randomness in
        train mode; without it, or in eval mode, no dropout."""
        seeds = iter(())
        if self.training and self.dropout > 0.0 and generator is not None:
            n = 2 * sum(self.depths[:3]) + self.depths[3]
            seeds = iter(torch.randint(0, 2 ** 62, (n,), generator=generator).tolist())
        x = x.permute(0, 2, 3, 1).to(self.dtype)
        x = gelu(batch_norm(conv2d(x, self.stem[0]), self.stem[1]))
        skips = []
        for s in range(3):
            for blk in self.encoder_stages[s]:
                x = self._block(blk, x, None, next(seeds, None))
            skips.append(x)
            x = self.downsample_layers[s](x)
        for blk in self.bottleneck:
            x = self._block(blk, x, None, next(seeds, None))
        for d, s in enumerate((2, 1, 0)):
            x = self.upsample_layers[d](x)
            skip = skips[s]
            x = bilinear_resize(x, skip.shape[1:3])
            for i, blk in enumerate(self.decoder_stages[d]):
                x = self._block(blk, x, skip if i == 0 else None, next(seeds, None))
        head = self.output_head
        x = gelu(batch_norm(conv2d(x, head[0]), head[1]))
        x = torch.sigmoid(conv2d(x, head[3]).float())
        return x.permute(0, 3, 1, 2)
