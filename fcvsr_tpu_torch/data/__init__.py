"""Data of the port: clip folders, windows, crops and flips (numpy)."""

from .datasets import ClipFolderDataset

__all__ = ["ClipFolderDataset"]
