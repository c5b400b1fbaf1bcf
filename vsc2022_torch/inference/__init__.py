"""Descriptor extraction: video decode, on-device preprocessing, the
batched model forward, and the inference CLI."""
