"""Overlap-add separation."""
from .inference import SourceSeparator, load_separator_from_checkpoint

__all__ = ["SourceSeparator", "load_separator_from_checkpoint"]
