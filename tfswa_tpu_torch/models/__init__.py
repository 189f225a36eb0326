"""TFSWA-UNet model family (NHWC internals, reference state_dict names)."""
from .attention import (FrequencySequenceAttention, MultiHeadAttention, RowBlockParams,
                        ShiftedWindowAttention, TemporalSequenceAttention, mha_rows,
                        row_transformer_block, scaled_dot_product_attention)
from .blocks import DownsampleBlock, TFSWABlock, UpsampleBlock
from .tfswa_unet import TFSWAUNet

__all__ = [
    "TFSWAUNet", "TFSWABlock", "DownsampleBlock", "UpsampleBlock",
    "TemporalSequenceAttention", "FrequencySequenceAttention",
    "ShiftedWindowAttention", "MultiHeadAttention", "RowBlockParams", "mha_rows",
    "scaled_dot_product_attention", "row_transformer_block",
]
