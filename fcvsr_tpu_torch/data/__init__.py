"""Data of the port: clip folders, Vimeo-90K septuplets, annotation
files, the CVCP and coding-prior caches, MM522 and LMDB shards; windows,
crops and flips (numpy); the threaded native PNG decoder
(``native_loader``)."""

from .datasets import (AnnotationDataset, ClipFolderDataset, CVCPClipCache,
                       MM522Dataset, SideInfoClipCache, Vimeo90KDataset,
                       as_model_input, load_image)
from .lmdb_reader import LmdbReader, SRLmdbDataset
from .lmdb_writer import LmdbWriter, write_lmdb
from .pipelines import (padded_window_indices, paired_flip_rotate,
                        paired_random_crop, segment_indices, to_float)

__all__ = ["ClipFolderDataset", "Vimeo90KDataset", "AnnotationDataset",
           "CVCPClipCache", "SideInfoClipCache", "MM522Dataset",
           "LmdbReader", "SRLmdbDataset", "LmdbWriter", "write_lmdb",
           "as_model_input", "load_image", "padded_window_indices",
           "paired_flip_rotate", "paired_random_crop", "segment_indices",
           "to_float"]
