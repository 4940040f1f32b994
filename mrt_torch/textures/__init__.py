"""Textures (mirrors ``mrt.textures``)."""
