"""Leaf-path conventions shared with the reference's checkpoints and artifacts."""
