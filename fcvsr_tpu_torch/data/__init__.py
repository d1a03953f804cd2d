"""Data of the port: clip folders, Vimeo-90K septuplets, windows, crops
and flips (numpy)."""

from .datasets import ClipFolderDataset, Vimeo90KDataset

__all__ = ["ClipFolderDataset", "Vimeo90KDataset"]
