"""Data of the port: clip folders, Vimeo-90K septuplets, annotation
files, the CVCP and coding-prior caches, MM522 and LMDB shards; windows,
crops and flips (numpy)."""

from .datasets import (AnnotationDataset, ClipFolderDataset, CVCPClipCache,
                       MM522Dataset, SideInfoClipCache, Vimeo90KDataset)
from .lmdb_reader import LmdbReader, SRLmdbDataset
from .lmdb_writer import LmdbWriter, write_lmdb

__all__ = ["ClipFolderDataset", "Vimeo90KDataset", "AnnotationDataset",
           "CVCPClipCache", "SideInfoClipCache", "MM522Dataset",
           "LmdbReader", "SRLmdbDataset", "LmdbWriter", "write_lmdb"]
