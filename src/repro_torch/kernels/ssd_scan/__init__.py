"""Mamba2 SSD chunked scan: plain version, wrapper and launch count."""
