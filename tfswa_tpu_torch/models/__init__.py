"""TFSWA-UNet model family (NHWC internals, reference state_dict names)."""
from .attention import (FrequencySequenceAttention, RowBlockParams,
                        ShiftedWindowAttention, TemporalSequenceAttention,
                        mha_rows, row_transformer_block)
from .blocks import DownsampleBlock, TFSWABlock, UpsampleBlock
from .tfswa_unet import TFSWAUNet

__all__ = [
    "TFSWAUNet", "TFSWABlock", "DownsampleBlock", "UpsampleBlock",
    "TemporalSequenceAttention", "FrequencySequenceAttention",
    "ShiftedWindowAttention", "RowBlockParams", "mha_rows",
    "row_transformer_block",
]
