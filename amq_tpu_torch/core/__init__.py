"""Bit packing, HQQ quantization and device selection."""
